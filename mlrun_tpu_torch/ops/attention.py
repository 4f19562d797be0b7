"""Attention ops: the plain reference, the flash forward of serving and
training and the training backward (kernels and plain versions), the
differentiable ``flash_attention_mlt``, and the dispatch knobs.

Counterpart of ``mlrun_tpu/ops/attention.py``. The Pallas bodies of
``_flash_v2_body`` (``_flash_fwd_kernel_v2_cached``, ``_bounded`` and the
training ``_flash_fwd_kernel_v2``) become one hand-written CUDA forward
with an integer ``k_lo`` and a causal flag, entered through
``csrc/flash_fwd_cached.cu``; the XLA backward ``_blockwise_bwd`` becomes
``csrc/flash_bwd.cu``. Both pick their kernel by dtype: bf16 runs on the
tensor cores (``csrc/flash_fwd_tc.cu``, ``csrc/flash_bwd_tc.cu``), float32
on float32 FMA tiles. The v1
Pallas body ``_flash_fwd_kernel`` (entry point ``_flash_fwd``) computes the
training forward's function, so its counterpart launches that same kernel
(``mlt_flash_fwd``) under a launch counter of its own. Public
functions keep the JAX signatures and layouts: q ``[B, S, H, D]``, k/v
``[B, M, H, D]`` (or at the kv head count, which the kernels index as
``h // (H // Hkv)``), lse ``[B, H, S]`` float32.

A wrapper given CPU tensors computes the plain PyTorch version; given CUDA
tensors it launches the kernel or raises. There is no fallback between the
two.
"""

from __future__ import annotations

import torch

from . import _build

NEG_INF = -2.0**30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: repeat kv heads to match q heads. [B, S, Hkv, D] -> [B, S,
    Hkv*n, D] (head h*n_rep + r is kv head h, the reference's order)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def attention_reference(q, k, v, causal: bool = True,
                        positions_q=None, positions_k=None,
                        softmax_scale: float | None = None) -> torch.Tensor:
    """[B, Sq, Hq, D] x [B, Sk, Hkv, D] -> [B, Sq, Hq, D]; f32 softmax."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = softmax_scale or (q.shape[-1] ** -0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        if positions_q is None:
            positions_q = torch.arange(q.shape[1], device=q.device)
        if positions_k is None:
            positions_k = torch.arange(k.shape[1], device=q.device)
        mask = positions_q[:, None] >= positions_k[None, :]
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def resolve_prefill_impl(impl: str = "auto",
                         device: torch.device | str = "cuda") -> str:
    """Resolve a serving ``attention_impl`` knob to the prefill attention
    path for tensors on ``device``: ``flash`` (the cached flash kernel, and
    on a prefix hit the paged prefill kernel) or ``dense`` (the masked
    softmax ``_cached_attention`` and the gather fallback). ``auto`` picks
    the kernels for CUDA and the plain paths for the CPU; an explicit
    ``flash``/``kernel`` on the CPU raises ``KernelUnavailableError``."""
    device = torch.device(device)
    if impl in ("flash", "kernel"):
        if device.type != "cuda":
            from .paged_attention import KernelUnavailableError

            raise KernelUnavailableError(
                f"attention_impl='{impl}' requested on {device}: the "
                "kernels are CUDA kernels — use 'auto' or 'reference'")
        return "flash"
    if impl in ("reference", "dense"):
        return "dense"
    if impl != "auto":
        raise ValueError(
            f"unknown prefill attention impl '{impl}' "
            "(auto | flash | kernel | reference | dense)")
    return "flash" if device.type == "cuda" else "dense"


# ---------------------------------------------------------------------------
# cached flash forward: plain version and CUDA kernel
# ---------------------------------------------------------------------------

def _flash_fwd_plain(q, k, v, q_offset: int, k_lo: int, causal: bool,
                     kv_len: int):
    """The arithmetic of ``csrc/flash_fwd_cached.cu`` in plain PyTorch: q
    rows at ``q_offset + i`` over kv rows ``k_lo <= k_pos < kv_len`` (and
    ``k_pos <= q_offset + i`` when causal), softmax in f32. Returns (o in
    q's dtype, lse [B, H, S] f32)."""
    b, s, h, d = q.shape
    m = k.shape[1]
    n_rep = h // k.shape[2]
    kf = _repeat_kv(k.float(), n_rep)
    vf = _repeat_kv(v.float(), n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, kf)
    k_pos = torch.arange(m, device=q.device)
    q_pos = q_offset + torch.arange(s, device=q.device)
    mask = (k_pos[None, :] >= k_lo) & (k_pos[None, :] < kv_len)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    logits = torch.where(mask[None, None], logits,
                         torch.full_like(logits, NEG_INF))
    mx = logits.amax(dim=-1)
    weight = torch.exp(logits - mx[..., None])
    denom = weight.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", weight / denom[..., None], vf)
    return o.to(q.dtype), mx + torch.log(denom)


def flash_fwd_cached_plain(q, k, v, q_offset: int, k_lo: int = 0):
    """Plain PyTorch version of ``csrc/flash_fwd_cached.cu``'s serving
    form: causal attention of q rows at ``q_offset + i`` over kv rows
    ``k_lo <= k_pos <= q_offset + i``. Returns (o, lse [B, H, S] f32)."""
    return _flash_fwd_plain(q, k, v, q_offset, k_lo, True, k.shape[1])


def _check_cuda(name: str, tensors: dict, dtype):
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, expected CUDA")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_qkv(name: str, q, k, v):
    b, s, h, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")


def flash_fwd_cached(q, k, v, q_offset: int, k_lo: int = 0):
    """(o, lse) of causal cached attention (see
    :func:`flash_fwd_cached_plain`). CUDA tensors launch
    ``csrc/flash_fwd_cached.cu`` (the replacement for the Pallas
    ``_flash_fwd_kernel_v2_cached`` / ``_bounded`` bodies); CPU tensors
    take the plain version. ``q_offset``/``k_lo`` are host ints."""
    q_offset, k_lo = int(q_offset), int(k_lo)
    if q.device.type == "cpu":
        return flash_fwd_cached_plain(q, k, v, q_offset, k_lo)
    _check_qkv("flash_fwd_cached", q, k, v)
    b, s, h, d = q.shape
    if q_offset < 0 or k_lo < 0:
        raise ValueError("flash_fwd_cached: q_offset and k_lo must be >= 0")
    _check_cuda("flash_fwd_cached", {"q": q, "k": k, "v": v}, q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _build.library().mlt_flash_fwd_cached(
        _build.dtype_code(q), d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, s, k.shape[1], h, k.shape[2],
        q_offset, k_lo, d ** -0.5, _build.stream_ptr(q))
    _build.check_launch("flash_fwd_cached", err)
    return o, lse


def _flash_fwd_v2_cached(q, k, v, q_offset):
    """Causal flash where q rows sit at absolute positions ``q_offset + i``
    against kv rows indexed from 0 — the serving prefill form. Returns
    (o, lse). A row's key tiles are cut at fixed multiples of 64 from
    position 0 and visited in ascending order whatever ``q_offset`` is, so
    chunked and unchunked prefills of the same cache are bit-identical."""
    return flash_fwd_cached(q, k, v, q_offset, 0)


def _flash_fwd_v2_cached_bounded(q, k, v, q_offset, k_lo):
    """Causal cached flash with a kv lower bound: rows < ``k_lo`` are
    masked out (the suffix prefill of a paged prefix-cache hit; those
    positions live in pool pages and are attended by the paged prefill
    kernel). Returns (o, lse) for ``merge_softmax_states``."""
    return flash_fwd_cached(q, k, v, q_offset, k_lo)


def flash_attention_cached(q, k, v, q_start) -> torch.Tensor:
    """Forward-only flash over a KV cache: q [B, S, H, D] rows at
    positions ``q_start + i``; k/v [B, M, H or Hkv, D] the cache with the
    current rows written at q_start..q_start+S."""
    o, _ = _flash_fwd_v2_cached(q, k, v, q_start)
    return o


# ---------------------------------------------------------------------------
# training flash: forward and backward (plain versions and CUDA kernels),
# the autograd function, and the dispatcher
# ---------------------------------------------------------------------------

def flash_fwd_plain(q, k, v, causal: bool = True, kv_len: int | None = None):
    """Plain PyTorch version of the training flash forward
    (``_flash_fwd_v2``; ``mlt_flash_fwd`` in ``csrc/flash_fwd_cached.cu``):
    self-attention with q and kv positions from 0, causal or not; keys at
    ``k_pos >= kv_len`` (default: all of k) are masked as the Pallas body
    masks its padded tail. Returns (o in q's dtype, lse [B, H, S] f32)."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    return _flash_fwd_plain(q, k, v, 0, 0, causal, kv_len)


def flash_bwd_plain(q, k, v, o, lse, g, causal: bool = True,
                    kv_len: int | None = None, block: int = 512):
    """Plain PyTorch version of ``csrc/flash_bwd.cu``: a port of the
    reference's ``_blockwise_bwd`` — recompute the attention block by block
    over the keys, ``delta = sum(o * g)`` in f32 from the stored ``o``,
    keys at ``k_pos >= kv_len`` masked. k/v may sit at the kv head count:
    dk/dv come back there, summed over each group of query heads (the VJP
    of ``_repeat_kv``). Returns (dq, dk, dv) in the input dtypes."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    kv_len = sk if kv_len is None else int(kv_len)
    scale = d ** -0.5
    qf, gf = q.float(), g.float()
    kf = _repeat_kv(k.float(), n_rep)
    vf = _repeat_kv(v.float(), n_rep)
    delta = (o.float() * gf).sum(dim=-1).transpose(1, 2)[..., None]
    q_pos = torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for start in range(0, sk, block):
        ks = kf[:, start:start + block]
        vs = vf[:, start:start + block]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, ks) * scale
        k_pos = start + torch.arange(ks.shape[1], device=q.device)[None, :]
        mask = k_pos < kv_len
        if causal:
            mask = mask & (q_pos >= k_pos)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, vs)
        ds = p * (dp - delta) * scale
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, ks)
        dk[:, start:start + block] = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        dv[:, start:start + block] = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dk = dk.view(b, sk, hkv, n_rep, d).sum(dim=3)
    dv = dv.view(b, sk, hkv, n_rep, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch_flash_fwd(name: str, q, k, v, causal: bool):
    """Launch ``mlt_flash_fwd`` (self-attention from position 0, keys past
    k's length masked) and count it under ``name``."""
    _check_qkv(name, q, k, v)
    _check_cuda(name, {"q": q, "k": k, "v": v}, q.dtype)
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _build.library().mlt_flash_fwd(
        _build.dtype_code(q), d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, s, k.shape[1], h, k.shape[2],
        int(bool(causal)), d ** -0.5, _build.stream_ptr(q))
    _build.check_launch(name, err)
    return o, lse


def flash_fwd(q, k, v, causal: bool = True):
    """(o, lse) of the training flash forward (see :func:`flash_fwd_plain`).
    CUDA tensors launch ``mlt_flash_fwd`` of ``csrc/flash_fwd_cached.cu``
    (the replacement for the Pallas ``_flash_fwd_kernel_v2``); CPU tensors
    take the plain version."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    return _launch_flash_fwd("flash_fwd", q, k, v, causal)


# head dims csrc/flash_fwd_cached.cu is instantiated for
FLASH_HEAD_DIMS = (32, 64, 128)


def _flash_fwd(q, k, v, causal: bool = True, block_q: int = 256,
               block_k: int = 256):
    """Counterpart of the reference's v1 flash entry point ``_flash_fwd``
    (Pallas ``_flash_fwd_kernel``): q [B, Sq, H, D] over k/v [B, Sk, H
    (or Hkv), D], q and kv positions from 0, causal with top-left alignment
    or not, keys past Sk masked (the Pallas body's padded-tail ``kv_len``).
    Returns (o in q's dtype, lse [B, H, Sq] f32). That is the function of
    the training forward, so CUDA tensors launch the same hand-written
    ``mlt_flash_fwd`` (``csrc/flash_fwd_cached.cu``), counted as
    ``flash_v1``; CPU tensors take :func:`flash_fwd_plain`. ``block_q`` /
    ``block_k`` tile the Pallas grid and do not change the result; they are
    only validated (the TPU-only ``interpret`` flag is not taken)."""
    if int(block_q) <= 0 or int(block_k) <= 0:
        raise ValueError(f"_flash_fwd: block_q and block_k must be > 0, got "
                         f"{block_q} / {block_k}")
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    if q.shape[-1] not in FLASH_HEAD_DIMS:
        from .paged_attention import KernelUnavailableError

        raise KernelUnavailableError(
            f"_flash_fwd: head_dim {q.shape[-1]} has no CUDA kernel "
            f"(csrc/flash_fwd_cached.cu takes {FLASH_HEAD_DIMS})")
    return _launch_flash_fwd("flash_v1", q, k, v, causal)


def flash_bwd(q, k, v, o, lse, g, causal: bool = True):
    """(dq, dk, dv) of the training flash (see :func:`flash_bwd_plain`).
    CUDA tensors launch ``csrc/flash_bwd.cu`` (the counterpart of the
    reference's XLA ``_blockwise_bwd``); CPU tensors take the plain
    version. dk/dv come back at k's head count."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, g, causal)
    _check_qkv("flash_bwd", q, k, v)
    if o.shape != q.shape or g.shape != q.shape \
            or lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"flash_bwd: o {tuple(o.shape)} / g "
                         f"{tuple(g.shape)} / lse {tuple(lse.shape)} do "
                         f"not match q {tuple(q.shape)}")
    _check_cuda("flash_bwd", {"q": q, "k": k, "v": v, "o": o, "g": g},
                q.dtype)
    _check_cuda("flash_bwd", {"lse": lse}, torch.float32)
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _build.library().mlt_flash_bwd(
        _build.dtype_code(q), d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), g.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b, sq, k.shape[1], h,
        k.shape[2], int(bool(causal)), d ** -0.5, _build.stream_ptr(q))
    _build.check_launch("flash_bwd", err)
    return dq, dk, dv


# The launches are registered as operators so that a selective activation
# checkpoint policy (models/llama.py, remat_policy="save_attn") sees them:
# a ctypes call is invisible to it, an operator is not.
@torch.library.custom_op("mlrun_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, causal)


@_flash_fwd_op.register_fake
def _(q, k, v, causal):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


@torch.library.custom_op("mlrun_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                  causal: bool
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_bwd(q, k, v, o, lse, g, causal)


@_flash_bwd_op.register_fake
def _(q, k, v, o, lse, g, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


FLASH_FWD_OP = torch.ops.mlrun_tpu_torch.flash_fwd.default


class FlashAttentionMLT(torch.autograd.Function):
    """Counterpart of the reference's ``flash_attention_mlt`` custom VJP:
    the forward saves (q, k, v, o, lse), the backward recomputes the
    attention block by block from them. On CUDA both directions launch
    the port's kernels; on the CPU both run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _flash_fwd_op(q, k, v, bool(causal))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = bool(causal)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_op(q, k, v, o, lse, g.contiguous(),
                                   ctx.causal)
        return dq, dk, dv, None


def flash_attention_mlt(q, k, v, causal: bool = True) -> torch.Tensor:
    """Differentiable flash attention: q [B, S, H, D], k/v [B, S, H or Hkv,
    D] (unlike the reference, kv need not be repeated to the q heads; its
    gradient comes back at kv's head count). Returns o [B, S, H, D]."""
    return FlashAttentionMLT.apply(q, k, v, causal)


ATTENTION_IMPLS = ("auto", "flash", "mlt_flash", "reference")


def attention(q, k, v, causal: bool = True,
              impl: str = "auto") -> torch.Tensor:
    """Dispatching attention: [B, S, H|Hkv, D] in, [B, S, H, D] out.
    ``reference`` is the plain softmax attention; ``auto``, ``flash`` and
    ``mlt_flash`` all take the port's own flash (the reference's library
    kernel ``_jax_flash`` has no counterpart here): the CUDA kernels for
    CUDA tensors, their plain versions for CPU tensors."""
    if impl == "reference":
        return attention_reference(q, k, v, causal=causal)
    if impl in ("auto", "flash", "mlt_flash"):
        return flash_attention_mlt(q, k, v, causal)
    raise ValueError(f"unknown attention impl '{impl}' "
                     f"({' | '.join(ATTENTION_IMPLS)})")
