"""Paged attention: decode, prefix prefill and speculative verify straight
off the KV page pool.

Counterpart of ``mlrun_tpu/ops/paged_attention.py``. The three Pallas
kernels on the serving path become hand-written CUDA kernels, each for
native pages and for int8 pages with float32 per-vector scales:

- ``_paged_decode_kernel`` -> ``csrc/paged_decode.cu`` (one token per
  slot, through the page table);
- ``_paged_prefill_kernel`` -> ``csrc/paged_prefill.cu`` (a prompt chunk
  over the ``base`` cached prefix tokens, in place);
- ``_paged_verify_kernel`` -> ``csrc/paged_prefill.cu``'s verify entry
  (every slot's speculative chunk over its own prefix, through its own
  page-table row).

Layouts are the reference's: q ``[slots, H, D]`` / ``[S, H, D]`` /
``[slots, S, H, D]``; pages ``[P+1, page_size, Hkv, D]`` whose last page
is the scratch page; page-table entries of -1 route to it; int8 pools
pass ``k_scale``/``v_scale`` ``[P+1, page_size, Hkv]`` float32, and the
plain versions dequantize after the gather, in float32, as the
reference's do. ``merge_softmax_states`` and ``chunk_causal_part`` stay
plain PyTorch, as in the reference.
"""

from __future__ import annotations

import threading

import torch

from . import _build
from .attention import NEG_INF, _check_cuda, _repeat_kv


class KernelUnavailableError(ValueError):
    """An EXPLICIT ``attention_impl="kernel"``/``"flash"`` request cannot be
    honored: the tensors are not on a CUDA device. Raised at engine
    construction — a silent downgrade would serve on the plain path while
    the operator believes the kernel is live."""


def resolve_paged_impl(impl: str = "auto",
                       device: torch.device | str = "cuda") -> str:
    """Resolve a serving ``attention_impl`` knob to the paged-decode path
    for a pool on ``device``: ``kernel`` (CUDA, page-table indexed) or
    ``reference`` (gather + dense). ``flash`` counts as an explicit kernel
    request, ``dense`` as an explicit reference request. ``auto`` picks the
    kernel for CUDA and the reference for the CPU; an explicit kernel
    request on the CPU raises :class:`KernelUnavailableError`."""
    device = torch.device(device)
    if impl in ("kernel", "flash"):
        if device.type != "cuda":
            raise KernelUnavailableError(
                f"attention_impl='{impl}' requested on {device}: the paged "
                "kernels are CUDA kernels — use 'auto' or 'reference'")
        return "kernel"
    if impl in ("reference", "dense"):
        return "reference"
    if impl != "auto":
        raise ValueError(
            f"unknown paged attention impl '{impl}' "
            "(auto | flash | kernel | reference | dense)")
    return "kernel" if device.type == "cuda" else "reference"


def _gather_pages(pages, ids, scale=None):
    """[P+1, ps, Hkv, D] pages at ``ids`` [..., pps] (-1 -> page 0; callers
    mask those positions) -> [..., pps * ps, Hkv, D] float32. int8 pages
    pass their per-vector ``scale`` [P+1, ps, Hkv] and are dequantized
    after the gather, in float32."""
    safe = ids.clamp_min(0).long()
    g = pages[safe].float()               # [..., pps, ps, Hkv, D]
    if scale is not None:
        g = g * scale[safe][..., None]
    shape = g.shape[:-4] + (g.shape[-4] * g.shape[-3],) + g.shape[-2:]
    return g.reshape(shape)


def _check_scales(name, k_pages, k_scale, v_scale):
    """The int8 kernels take int8 pages with float32 scales of shape
    pages.shape[:-1]; both scales or neither."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: pass both k_scale and v_scale or neither")
    if k_scale is None:
        return
    if k_scale.shape != k_pages.shape[:-1] or v_scale.shape != k_scale.shape:
        raise ValueError(f"{name}: scales {tuple(k_scale.shape)} / "
                         f"{tuple(v_scale.shape)} for pages "
                         f"{tuple(k_pages.shape)}")
    _check_cuda(name, {"k_scale": k_scale, "v_scale": v_scale},
                torch.float32)


def _check_pages(name, q, k_pages, v_pages, page_size, k_scale, v_scale):
    """Shapes, devices and dtypes a paged kernel takes: pages [P+1,
    page_size, Hkv, D] in q's dtype, or int8 with float32 scales."""
    h, d = q.shape[-2:]
    hkv = k_pages.shape[2]
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[1] != page_size or k_pages.shape[3] != d \
            or h % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, page_size {page_size}")
    _check_cuda(name, {"q": q}, q.dtype)
    _check_scales(name, k_pages, k_scale, v_scale)
    _check_cuda(name, {"k_pages": k_pages, "v_pages": v_pages},
                torch.int8 if k_scale is not None else q.dtype)


def _scale_ptrs(k_scale, v_scale) -> tuple:
    return ((None, None) if k_scale is None
            else (k_scale.data_ptr(), v_scale.data_ptr()))


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def paged_decode_reference(q, k_pages, v_pages, page_table, pos,
                           page_size: int, k_scale=None, v_scale=None):
    """Plain version of ``csrc/paged_decode.cu``: gather every slot's pages
    (dequantized, on int8 pools) into a dense [slots, max_len] view and
    run masked attention (``k_pos <= pos``). Output in q's dtype."""
    slots, h, d = q.shape
    n_rep = h // k_pages.shape[2]
    kd = _repeat_kv(_gather_pages(k_pages, page_table, k_scale), n_rep)
    vd = _repeat_kv(_gather_pages(v_pages, page_table, v_scale), n_rep)
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), kd) * d ** -0.5
    k_pos = torch.arange(kd.shape[1], device=q.device)
    mask = k_pos[None, None, :] <= pos.long()[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", weights, vd).to(q.dtype)


# split-K chunk sizes, owned by the kernels and mirrored here to size their
# scratch (a launch refuses a scratch of too few chunks): the decode kernel
# takes max(1, DECODE_CHUNK_KEYS // page_size) pages of a slot a block
# (csrc/paged_decode.cu kChunkKeys), the bf16 verify kernel PREFIX_CHUNK_KEYS
# keys from position 0 (csrc/paged_prefill.cu kChunkTiles x 64)
DECODE_CHUNK_KEYS = 128
PREFIX_CHUNK_KEYS = 128
# zeroed int32 arrival counters of the split-K merges (decode, verify), one
# tensor per (device, stream): every launch leaves them zeroed, and
# launches on one stream are ordered. Several engines' scheduler threads
# (a fleet's replicas in one process) launch on the same stream, so the
# check-and-replace below holds a lock: two threads growing the tensor at
# once must not each keep a tensor the other replaced
_merge_counters: dict = {}
_merge_counters_lock = threading.Lock()


def _counters(device, stream: int, n: int) -> torch.Tensor:
    key = (device, stream)
    with _merge_counters_lock:
        have = _merge_counters.get(key)
        if have is None or have.numel() < n:
            have = torch.zeros(n, dtype=torch.int32, device=device)
            _merge_counters[key] = have
        return have


def _paged_decode_call(q, k_pages, v_pages, page_table, pos,
                       page_size: int, k_scale=None, v_scale=None):
    """q [slots, H, D] x pool pages [P+1, page_size, Hkv, D] -> [slots, H,
    D] in q's dtype. ``k_scale``/``v_scale`` select the int8 kernel. CUDA
    tensors launch ``csrc/paged_decode.cu`` (the replacement for the
    Pallas ``_paged_decode_kernel``), with its split-K scratch allocated
    here; CPU tensors take :func:`paged_decode_reference`."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, page_table, pos,
                                      page_size, k_scale, v_scale)
    slots, h, d = q.shape
    _check_pages("paged_decode", q, k_pages, v_pages, page_size, k_scale,
                 v_scale)
    if page_table.dim() != 2 or page_table.shape[0] != slots \
            or pos.shape != (slots,):
        raise ValueError(
            f"paged_decode: q {tuple(q.shape)}, table "
            f"{tuple(page_table.shape)}, pos {tuple(pos.shape)}")
    _check_cuda("paged_decode", {"page_table": page_table, "pos": pos},
                torch.int32)
    out = torch.empty_like(q)
    hkv, pps = k_pages.shape[2], page_table.shape[1]
    max_chunks = -(-pps // max(1, DECODE_CHUNK_KEYS // page_size))
    part = torch.empty(slots * h * max_chunks * (d + 2), dtype=torch.float32,
                       device=q.device)
    stream = _build.stream_ptr(q)
    counters = _counters(q.device, stream, slots * hkv)
    lib = _build.library()
    head = (_build.dtype_code(q), d, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr())
    tail = (page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), slots, h, hkv, page_size,
            pps, max_chunks, k_pages.shape[0] - 1, d ** -0.5, stream)
    if k_scale is not None:
        err = lib.mlt_paged_decode_int8(*head, *_scale_ptrs(k_scale, v_scale),
                                        *tail)
        _build.check_launch("paged_decode_int8", err)
    else:
        err = lib.mlt_paged_decode(*head, *tail)
        _build.check_launch("paged_decode", err)
    return out


def paged_attention(q, k_pages, v_pages, page_table, pos, *,
                    page_size: int, impl: str = "auto", k_scale=None,
                    v_scale=None):
    """Dispatching paged-decode attention; ``k_scale``/``v_scale`` select
    the int8 path in both impls."""
    impl = resolve_paged_impl(impl, q.device)
    if impl == "reference":
        return paged_decode_reference(q, k_pages, v_pages, page_table, pos,
                                      page_size, k_scale, v_scale)
    return _paged_decode_call(q, k_pages, v_pages, page_table, pos,
                              page_size, k_scale, v_scale)


# ---------------------------------------------------------------------------
# multi-row paged prefill: a prompt chunk over shared prefix pages in place
# ---------------------------------------------------------------------------

def _prefix_softmax(q, kd, vd, base):
    """Partial softmax state of q [R, S, H, D] over dense prefix views
    kd/vd [R, M, Hkv, D] (float32) with key positions >= ``base`` [R]
    masked: (o [R, S, H, D] f32, lse [R, H, S] f32). Masked keys weigh
    exactly 0, so a row with an empty prefix (base 0) gets o = 0 and lse
    = NEG_INF + log(1e-30), as the kernels give it."""
    d = q.shape[-1]
    n_rep = q.shape[2] // kd.shape[2]
    kd, vd = _repeat_kv(kd, n_rep), _repeat_kv(vd, n_rep)
    logits = torch.einsum("rqhd,rkhd->rhqk", q.float() * d ** -0.5, kd)
    k_pos = torch.arange(kd.shape[1], device=q.device)
    live = k_pos[None, :] < base.long()[:, None]              # [R, M]
    logits = torch.where(live[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    mx = logits.amax(dim=-1)                                  # [R, H, S]
    weight = torch.where(live[:, None, None],
                         torch.exp(logits - mx[..., None]),
                         torch.zeros_like(logits))
    denom = weight.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("rhqk,rkhd->rqhd", weight / denom[..., None], vd)
    return o, mx + torch.log(denom)


def paged_prefill_reference(q, k_pages, v_pages, page_ids, base: int,
                            page_size: int, k_scale=None, v_scale=None):
    """Plain version of ``csrc/paged_prefill.cu``: q [S, H, D] attends the
    prefix tokens 0..base-1 held in pool pages ``page_ids`` ([pps] int32,
    -1 past the prefix), dequantized on int8 pools. Returns (o [S, H, D]
    f32, lse [S, H] f32)."""
    kd = _gather_pages(k_pages, page_ids[None], k_scale)
    vd = _gather_pages(v_pages, page_ids[None], v_scale)
    bases = torch.full((1,), int(base), dtype=torch.long, device=q.device)
    o, lse = _prefix_softmax(q[None], kd, vd, bases)
    return o[0], lse[0].T.contiguous()


def _paged_prefill_call(q, k_pages, v_pages, page_ids, base: int,
                        page_size: int, k_scale=None, v_scale=None):
    """q [S, H, D] (one admission's prompt chunk, batch 1) attends the
    ``base`` prefix tokens stored in pool pages ``page_ids`` in place.
    Returns (o [S, H, D] f32, lse [S, H] f32). ``k_scale``/``v_scale``
    select the int8 kernel. CUDA tensors launch ``csrc/paged_prefill.cu``
    (the replacement for the Pallas ``_paged_prefill_kernel``); CPU tensors
    take :func:`paged_prefill_reference`. ``base`` is a host int."""
    base = int(base)
    if q.device.type == "cpu":
        return paged_prefill_reference(q, k_pages, v_pages, page_ids, base,
                                       page_size, k_scale, v_scale)
    s, h, d = q.shape
    _check_pages("paged_prefill", q, k_pages, v_pages, page_size, k_scale,
                 v_scale)
    if page_ids.dim() != 1:
        raise ValueError(f"paged_prefill: ids {tuple(page_ids.shape)}")
    if not 0 <= base <= page_ids.shape[0] * page_size:
        raise ValueError(f"paged_prefill: base {base} outside the "
                         f"{page_ids.shape[0]} pages")
    _check_cuda("paged_prefill", {"page_ids": page_ids}, torch.int32)
    o = torch.empty((s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((s, h), dtype=torch.float32, device=q.device)
    lib = _build.library()
    head = (_build.dtype_code(q), d, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr())
    tail = (page_ids.data_ptr(), o.data_ptr(), lse.data_ptr(), s, h,
            k_pages.shape[2], page_size, page_ids.shape[0],
            k_pages.shape[0] - 1, base, d ** -0.5, _build.stream_ptr(q))
    if k_scale is not None:
        err = lib.mlt_paged_prefill_int8(*head, *_scale_ptrs(k_scale,
                                                             v_scale), *tail)
        _build.check_launch("paged_prefill_int8", err)
    else:
        err = lib.mlt_paged_prefill(*head, *tail)
        _build.check_launch("paged_prefill", err)
    return o, lse


def merge_softmax_states(o_a, lse_a, o_b, lse_b):
    """LSE-merge two partial attention states over disjoint kv sets:
    ``o_*`` [B, S, H, D] (any float dtype), ``lse_*`` [B, H, S] f32.
    Returns the combined f32 output."""
    la = lse_a.transpose(1, 2)[..., None]         # [B, S, H, 1]
    lb = lse_b.transpose(1, 2)[..., None]
    m = torch.maximum(la, lb)
    wa = torch.exp(la - m)
    wb = torch.exp(lb - m)
    return (o_a.float() * wa + o_b.float() * wb) / (wa + wb)


def paged_prefix_part(q, k_pages, v_pages, page_ids, base, *,
                      page_size: int, k_scale=None, v_scale=None):
    """Batch-1 form of :func:`_paged_prefill_call`: q [1, S, H, D] ->
    (o [1, S, H, D] f32, lse [1, H, S] f32), ready for
    :func:`merge_softmax_states`."""
    o, lse = _paged_prefill_call(q[0], k_pages, v_pages, page_ids, base,
                                 page_size, k_scale, v_scale)
    return o[None], lse.T[None]


def paged_prefill_attention(q, k_cache, v_cache, q_start, k_pages, v_pages,
                            page_ids, base, *, page_size: int, k_scale=None,
                            v_scale=None):
    """Merged suffix-prefill attention on a prefix-cache hit: q [1, S, H,
    D] rows at ``q_start + i``; the local cache k/v [1, M, H or Hkv, D]
    holds rows from ``base``; prefix tokens 0..base-1 live in pool pages
    and are attended in place. Returns the merged [1, S, H, D] f32
    output."""
    from .attention import _flash_fwd_v2_cached_bounded

    o_loc, lse_loc = _flash_fwd_v2_cached_bounded(q, k_cache, v_cache,
                                                  q_start, base)
    o_pre, lse_pre = paged_prefix_part(q, k_pages, v_pages, page_ids, base,
                                       page_size=page_size, k_scale=k_scale,
                                       v_scale=v_scale)
    return merge_softmax_states(o_pre, lse_pre, o_loc, lse_loc)


# ---------------------------------------------------------------------------
# batched multi-row verify: a speculative chunk per slot over the page pool
# ---------------------------------------------------------------------------

def paged_verify_prefix_reference(q, k_pages, v_pages, page_table, base,
                                  page_size: int, k_scale=None,
                                  v_scale=None):
    """Plain version of ``csrc/paged_prefill.cu``'s verify entry: every
    slot's chunk q [slots, S, H, D] attends its own prefix 0..base[r]-1
    through its page-table row. Returns (o [slots, S, H, D] f32, lse
    [slots, H, S] f32)."""
    kd = _gather_pages(k_pages, page_table, k_scale)
    vd = _gather_pages(v_pages, page_table, v_scale)
    return _prefix_softmax(q, kd, vd, base)


def _paged_verify_call(q, k_pages, v_pages, page_table, base,
                       page_size: int, k_scale=None, v_scale=None):
    """q [slots, S, H, D] (every slot's speculative verify chunk) attends
    each row's prefix tokens 0..base[r]-1 in place through the page table
    — the batched form of :func:`_paged_prefill_call`. Returns (o [slots,
    S, H, D] f32, lse [slots, H, S] f32) for :func:`merge_softmax_states`.
    CUDA tensors launch ``mlt_paged_verify`` (the replacement for the
    Pallas ``_paged_verify_kernel``); CPU tensors take
    :func:`paged_verify_prefix_reference`."""
    if q.device.type == "cpu":
        return paged_verify_prefix_reference(q, k_pages, v_pages,
                                             page_table, base, page_size,
                                             k_scale, v_scale)
    slots, s, h, d = q.shape
    _check_pages("paged_verify", q, k_pages, v_pages, page_size, k_scale,
                 v_scale)
    if page_table.dim() != 2 or page_table.shape[0] != slots \
            or base.shape != (slots,):
        raise ValueError(f"paged_verify: q {tuple(q.shape)}, table "
                         f"{tuple(page_table.shape)}, base "
                         f"{tuple(base.shape)}")
    _check_cuda("paged_verify", {"page_table": page_table, "base": base},
                torch.int32)
    o = torch.empty((slots, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((slots, s, h), dtype=torch.float32, device=q.device)
    hkv, pps = k_pages.shape[2], page_table.shape[1]
    stream = _build.stream_ptr(q)
    part = counters = None
    max_chunks = -(-pps * page_size // PREFIX_CHUNK_KEYS)
    if q.dtype == torch.bfloat16:   # the tensor-core body's split-K state
        rows = s * (h // hkv)
        part = torch.empty(slots * hkv * max_chunks * rows * (d + 2),
                           dtype=torch.float32, device=q.device)
        counters = _counters(q.device, stream, slots * hkv * -(-rows // 64))
    err = _build.library().mlt_paged_verify(
        _build.dtype_code(q), d, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), *_scale_ptrs(k_scale, v_scale),
        page_table.data_ptr(), base.data_ptr(), o.data_ptr(), lse.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), max_chunks, slots,
        s, h, hkv, page_size, pps, k_pages.shape[0] - 1, d ** -0.5, stream)
    _build.check_launch(
        "paged_verify_int8" if k_scale is not None else "paged_verify", err)
    return o, lse.transpose(1, 2)


def chunk_causal_part(q, k, v):
    """Causal partial softmax of a verify chunk over itself: q [B, S, H,
    D], k/v [B, S, Hkv, D] (the chunk's own KV — on int8 pools the caller
    passes the quantize -> dequantize round trip, so the chunk attends
    what the pool stores). Returns (o [B, S, H, D] f32, lse [B, H, S]
    f32) for :func:`merge_softmax_states` with the paged prefix part."""
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    k = _repeat_kv(k.float(), n_rep)
    v = _repeat_kv(v.float(), n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * d ** -0.5
    i = torch.arange(s, device=q.device)
    causal = i[None, :] <= i[:, None]                  # [q, kv]
    logits = torch.where(causal[None, None], logits,
                         torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)                            # [B, H, S]
    w = torch.exp(logits - m[..., None])
    l = w.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", w / l[..., None], v)
    return o, m + torch.log(l)


def paged_verify_reference(q, chunk_k, chunk_v, k_pages, v_pages,
                           page_table, base, page_size: int, k_scale=None,
                           v_scale=None):
    """Dense-view verify: gather every slot's pages into [slots, max_len]
    (dequantized on int8 pools), splice the chunk KV at positions ``base[r]
    + i`` and run one masked softmax with the bound ``k_pos <= base[r] +
    i``. A chunk lane past the view's tail is dropped (the reference's
    ``mode="drop"``), never clamped onto the row's last entry. Returns
    [slots, S, H, D] f32."""
    r, s, h, d = q.shape
    kd = _gather_pages(k_pages, page_table, k_scale)   # [r, M, Hkv, D]
    vd = _gather_pages(v_pages, page_table, v_scale)
    m = kd.shape[1]
    positions = base.long()[:, None] + torch.arange(s, device=q.device)
    inside = positions < m
    rows = torch.arange(r, device=q.device)[:, None].expand(r, s)
    kd[rows[inside], positions[inside]] = chunk_k.float()[inside]
    vd[rows[inside], positions[inside]] = chunk_v.float()[inside]
    n_rep = h // kd.shape[2]
    kd, vd = _repeat_kv(kd, n_rep), _repeat_kv(vd, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kd) * d ** -0.5
    k_pos = torch.arange(m, device=q.device)
    mask = k_pos[None, None, :] <= positions[:, :, None]      # [r, S, M]
    logits = torch.where(mask[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, vd)


def paged_verify_merged(q, chunk_k, chunk_v, k_pages, v_pages, page_table,
                        base, *, page_size: int, k_scale=None, v_scale=None):
    """The kernel route of :func:`paged_verify_attention`: the prefix part
    through :func:`_paged_verify_call` (the verify kernel on CUDA, its
    plain version on the CPU), LSE-merged with :func:`chunk_causal_part`.
    Returns [slots, S, H, D] f32."""
    o_pre, lse_pre = _paged_verify_call(q, k_pages, v_pages, page_table,
                                        base, page_size, k_scale, v_scale)
    o_loc, lse_loc = chunk_causal_part(q, chunk_k, chunk_v)
    return merge_softmax_states(o_pre, lse_pre, o_loc, lse_loc)


def paged_verify_attention(q, chunk_k, chunk_v, k_pages, v_pages,
                           page_table, base, *, page_size: int,
                           impl: str = "auto", k_scale=None, v_scale=None):
    """Speculative multi-token verify attention over the page pool: q
    [slots, S, H, D] are each row's positions ``base[r]..base[r] + S - 1``
    (the committed last token plus the draft tokens); their KV
    (``chunk_k``/``chunk_v`` [slots, S, Hkv, D]) is already in the pool.
    ``impl`` picks the kernel route (:func:`paged_verify_merged`) or the
    dense view (:func:`paged_verify_reference`). Returns [slots, S, H, D]
    f32."""
    if resolve_paged_impl(impl, q.device) == "reference":
        return paged_verify_reference(q, chunk_k, chunk_v, k_pages, v_pages,
                                      page_table, base, page_size, k_scale,
                                      v_scale)
    return paged_verify_merged(q, chunk_k, chunk_v, k_pages, v_pages,
                               page_table, base, page_size=page_size,
                               k_scale=k_scale, v_scale=v_scale)
