"""Llama-family transformer in plain PyTorch — counterpart of
``mlrun_tpu/models/llama.py``.

Parameters are a plain dict with the JAX tree's keys and layouts, so the
weight converter (models/convert.py) is a straight copy: ``embedding``
[vocab, E]; ``layers`` holding ``attn_norm_scale``, ``wq``, ``wk``, ``wv``,
``wo``, ``mlp_norm_scale``, ``w_gate``, ``w_up``, ``w_down``, each stacked
``[L, in, out]`` (norm scales ``[L, E]``); ``final_norm_scale`` [E]; and
``lm_head`` [E, vocab] when the embeddings are untied.

Training runs ``loss_fn`` (``hidden_states`` with per-layer activation
checkpointing, the chunked cross-entropy head); every layer's attention
goes through ``ops.attention.attention(impl=config.attention_impl)``, the
port's flash kernels on CUDA. With ``lora=`` (models/lora.py) each
adapted projection adds its low-rank delta in ``config.dtype``. Serving
runs ``serving/llm.py`` and ``serving/paged.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.attention import FLASH_FWD_OP, attention
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rope, rope_table

Params = dict


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    n_layers: int = 32
    embed_dim: int = 4096
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    remat: bool = True
    # remat policy under remat=True: "nothing" recomputes the whole layer
    # (min memory); "save_attn" keeps the flash forward's outputs (o, lse)
    # so the backward recomputes the projections and the MLP but not the
    # attention; "dots" saves every matmul output (max memory, min
    # recompute)
    remat_policy: str = "nothing"
    # auto | flash | mlt_flash (the port's flash kernels on CUDA, their
    # plain versions on the CPU) | reference (plain softmax attention)
    attention_impl: str = "auto"

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        embed = self.vocab_size * self.embed_dim
        per_layer = (
            self.embed_dim * self.qkv_dim
            + 2 * self.embed_dim * self.kv_dim
            + self.qkv_dim * self.embed_dim
            + 3 * self.embed_dim * self.mlp_dim
            + 2 * self.embed_dim
        )
        head = 0 if self.tie_embeddings else self.vocab_size * self.embed_dim
        return embed + self.n_layers * per_layer + self.embed_dim + head

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token (fwd+bwd ≈ 6·N_matmul + attention term)."""
        matmul_params = self.param_count() - self.vocab_size * self.embed_dim \
            * (1 if self.tie_embeddings else 2) - self.embed_dim \
            - 2 * self.embed_dim * self.n_layers
        # embedding lookup is free; lm_head matmul counts
        matmul_params += self.vocab_size * self.embed_dim
        attn = 2 * self.n_layers * seq_len * self.qkv_dim  # qk^T + pv per token
        return 6.0 * matmul_params + 6.0 * attn


# -- presets -----------------------------------------------------------------

def llama3_8b(**overrides) -> LlamaConfig:
    return dataclasses.replace(LlamaConfig(), **overrides)


def llama3_70b(**overrides) -> LlamaConfig:
    return dataclasses.replace(LlamaConfig(
        n_layers=80, embed_dim=8192, n_heads=64, n_kv_heads=8,
        mlp_dim=28672), **overrides)


def llama3_1b(**overrides) -> LlamaConfig:
    """~1.2B config (llama3.2-1B-like)."""
    return dataclasses.replace(LlamaConfig(
        vocab_size=128256, n_layers=16, embed_dim=2048, n_heads=32,
        n_kv_heads=8, head_dim=64, mlp_dim=8192, tie_embeddings=True),
        **overrides)


def tiny_llama(**overrides) -> LlamaConfig:
    """Tiny config for tests."""
    return dataclasses.replace(LlamaConfig(
        vocab_size=512, n_layers=2, embed_dim=128, n_heads=4, n_kv_heads=2,
        head_dim=32, mlp_dim=256, tie_embeddings=True, remat=False),
        **overrides)


# the preset names LLMModelServer(model_preset=...) takes (a copy of the
# reference's frameworks/jax/auto_trainer.MODEL_PRESETS)
MODEL_PRESETS = {
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
    "llama3-1b": llama3_1b,
    "tiny": tiny_llama,
}


# -- init --------------------------------------------------------------------

def normal_init(generator: torch.Generator, device, dtype):
    """``normal(fan_in, shape)``: a normal draw from ``generator`` scaled by
    ``fan_in**-0.5``, stored in ``dtype``. An array of three or more dims
    is drawn one trailing ``[in, out]`` matrix at a time (a stacked weight
    layer by layer), so the float32 draw never holds more than one."""

    def normal(fan_in, shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        flat = out.view(-1, *shape[-2:]) if len(shape) >= 3 else out[None]
        for view in flat:
            draw = torch.randn(view.shape, generator=generator,
                               device=device, dtype=torch.float32)
            view.copy_(draw.mul_(fan_in ** -0.5))
        return out

    return normal


def init_params(config: LlamaConfig, generator: torch.Generator,
                device: torch.device | str) -> Params:
    """Random params (normal, scaled by fan_in**-0.5) drawn on ``device``
    from ``generator`` (which must live on that device), stored in
    ``config.dtype``, each stacked weight layer by layer."""
    dtype = config.dtype
    e, h, kv, m, L = (config.embed_dim, config.qkv_dim, config.kv_dim,
                      config.mlp_dim, config.n_layers)
    normal = normal_init(generator, device, dtype)

    params: Params = {
        "embedding": normal(e, (config.vocab_size, e)),
        "layers": {
            "attn_norm_scale": torch.ones((L, e), dtype=dtype, device=device),
            "wq": normal(e, (L, e, h)),
            "wk": normal(e, (L, e, kv)),
            "wv": normal(e, (L, e, kv)),
            "wo": normal(h, (L, h, e)),
            "mlp_norm_scale": torch.ones((L, e), dtype=dtype, device=device),
            "w_gate": normal(e, (L, e, m)),
            "w_up": normal(e, (L, e, m)),
            "w_down": normal(m, (L, m, e)),
        },
        "final_norm_scale": torch.ones((e,), dtype=dtype, device=device),
    }
    if not config.tie_embeddings:
        params["lm_head"] = normal(e, (e, config.vocab_size))
    return params


def init_permutation_params(config: LlamaConfig, perm, scale: float = 50.0,
                            seed: int = 0,
                            device: torch.device | str = "cpu") -> Params:
    """Deterministic "permutation-following" params: the greedy next token
    after ``t`` is the unique ``v`` with ``perm[v] == t``. Every transformer
    weight is zero (the residual carries the embedding through untouched)
    and the untied head is ``scale * E[perm]^T``, so the argmax gaps are
    O(scale), far above float noise between differently shaped forwards.
    The embedding rows are unit-norm normal draws from a generator seeded
    ``seed + 1`` (the reference draws them from ``PRNGKey(seed + 1)``, so
    the two packages' rows differ; tests convert the reference's pair).
    Requires ``tie_embeddings=False``."""
    import numpy as np

    if config.tie_embeddings:
        raise ValueError("permutation params need an untied lm_head "
                         "(tie_embeddings=False)")
    dtype = config.dtype
    e, h, kv, m, L = (config.embed_dim, config.qkv_dim, config.kv_dim,
                      config.mlp_dim, config.n_layers)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 1)
    emb = torch.randn((config.vocab_size, e), generator=generator,
                      device=device, dtype=torch.float32)
    emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    perm = torch.as_tensor(np.asarray(perm), device=device).long()
    return {
        "embedding": emb.to(dtype),
        "layers": {
            "attn_norm_scale": ones(L, e), "wq": zeros(L, e, h),
            "wk": zeros(L, e, kv), "wv": zeros(L, e, kv),
            "wo": zeros(L, h, e), "mlp_norm_scale": ones(L, e),
            "w_gate": zeros(L, e, m), "w_up": zeros(L, e, m),
            "w_down": zeros(L, m, e),
        },
        "final_norm_scale": ones(e),
        "lm_head": (scale * emb[perm].T).to(dtype).contiguous(),
    }


def permutation_pair(vocab_size: int, overlap: float, seed: int = 0):
    """A target permutation plus a draft permutation agreeing on
    ``overlap`` of tokens, for :func:`init_permutation_params` model pairs
    (overlap 1.0: every draft proposal accepted). The target is one
    full-length cycle with the disagreements spaced evenly along it, so
    ``overlap`` is a uniform per-row acceptance dial. numpy's generator
    makes it, so it equals the reference's pair for the same seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    order = rng.permutation(vocab_size)           # cycle walk order
    target = np.empty(vocab_size, dtype=order.dtype)
    target[order] = np.roll(order, -1)            # single n-cycle
    draft = target.copy()
    n_diff = int(round(vocab_size * (1 - overlap)))
    n_diff -= n_diff % 2                          # swaps corrupt in pairs
    if n_diff >= 2:
        pos = np.linspace(0, vocab_size, n_diff,
                          endpoint=False).astype(np.int64)
        a, b = order[pos[0::2]], order[pos[1::2]]
        draft[a], draft[b] = target[b], target[a]
    return target, draft


def lm_head(params: Params) -> torch.Tensor:
    """[E, vocab] output projection (the transposed embedding when tied)."""
    head = params.get("lm_head")
    return params["embedding"].T if head is None else head


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two bf16 operands with float32 accumulation and a float32
    result: cuBLAS's float32-output product on CUDA (no float32 copy of
    either operand); the same function through float32 copies elsewhere
    (float32 operands: the plain product)."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _LogitsF32(torch.autograd.Function):
    """[N, E] x [E, vocab] -> float32 logits from a float32-output product
    of two bf16 operands (the reference's ``preferred_element_type=f32``).

    The reference's backward multiplies the float32 logit gradient with
    the operands. Here that gradient is split into two bf16 terms, ``hi =
    bf16(g)`` and ``lo = bf16(g - hi)``, which together carry 16
    significant bits (``|g - hi - lo| <= 2**-18 |g|``), and each operand's
    gradient is the float32 sum of two float32-accumulating bf16 products,
    cast down once. That is the float32-cotangent product to well below
    one bf16 rounding of the result, at twice the cost of a bf16 product
    (a float32 GEMM runs on the H100 at ~1/15 of the bf16 rate), and no
    float32 copy of the head is made."""

    @staticmethod
    def forward(ctx, x2d, head):
        ctx.save_for_backward(x2d, head)
        return _mm_f32(x2d, head)

    @staticmethod
    def backward(ctx, grad):
        x2d, head = ctx.saved_tensors
        grad = grad.float()
        hi = grad.to(x2d.dtype)
        lo = (grad - hi.float()).to(x2d.dtype)
        del grad
        head_t, x_t = head.t(), x2d.t()
        dx = _mm_f32(hi, head_t).add_(_mm_f32(lo, head_t))
        dhead = None
        if ctx.needs_input_grad[1]:  # a frozen head (LoRA) needs none
            dhead = _mm_f32(x_t, hi).add_(_mm_f32(x_t, lo)).to(head.dtype)
        return dx.to(x2d.dtype), dhead


def logits_f32(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """[..., E] x [E, vocab] -> float32 logits with float32 accumulation
    (the reference's ``preferred_element_type=f32``), differentiable. bf16
    on CUDA uses cuBLAS's float32-output product, so the head is never
    copied to f32."""
    if x.dtype == torch.float32 or x.device.type != "cuda":
        return torch.matmul(x.float(), head.float())
    lead = x.shape[:-1]
    out = _LogitsF32.apply(x.reshape(-1, x.shape[-1]), head)
    return out.reshape(*lead, head.shape[-1])


# -- forward -----------------------------------------------------------------

# the operators the "dots" policy saves (a [B, S, E] x [E, F] product
# reaches the dispatcher as one of these)
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})


def _remat_context(name: str):
    """Map a LlamaConfig.remat_policy name onto a checkpoint ``context_fn``
    (None: save nothing, recompute the whole layer)."""
    if name == "nothing":
        return None
    if name == "save_attn":
        saved = frozenset({FLASH_FWD_OP})
    elif name == "dots":
        saved = _DOT_OPS
    else:
        raise ValueError(
            f"unknown remat_policy '{name}' (nothing | save_attn | dots)")

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _proj(h, w, lora, target):
    """h @ w plus, where ``lora`` (one layer's adapter) adapts ``target``,
    ``scaling * (h @ A) @ B`` — all in h's dtype, with the factors cast
    to it (the reference's training form; serving adds its delta in
    float32 instead)."""
    out = h @ w
    if lora is not None and target in lora:
        parts = lora[target]
        delta = (h @ parts["lora_a"].to(h.dtype)) @ parts["lora_b"].to(h.dtype)
        out = out + parts["scaling"].to(h.dtype) * delta
    return out


def attention_half(config: LlamaConfig, x, lp, cos, sin, lora=None,
                   attention_fn=None, enter=None):
    """The attention block's rank-local half: RMSNorm of the residual ``x``
    [B, S, E], the q/k/v heads of this rank's ``wq``/``wk``/``wv`` columns
    (the head counts read off their widths), causal attention over them,
    and the product with this rank's rows of ``wo``. Returns the rank's
    partial of the block's output [B, S, E]; the partials of every tensor
    rank sum to the unsharded block's (a plain function of the rank's
    shards: one rank holding whole weights computes the whole block).
    ``enter`` (the tensor-parallel entry, parallel/tensor.py) is applied
    to the normalized input."""
    b, s, _ = x.shape
    d = config.head_dim
    h = rms_norm(x, lp["attn_norm_scale"], config.norm_eps)
    if enter is not None:
        h = enter(h)
    q = _proj(h, lp["wq"], lora, "wq").reshape(b, s, -1, d)
    k = _proj(h, lp["wk"], lora, "wk").reshape(b, s, -1, d)
    v = _proj(h, lp["wv"], lora, "wv").reshape(b, s, -1, d)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if attention_fn is None:
        attn = attention(q, k, v, causal=True, impl=config.attention_impl)
    else:
        attn = attention_fn(q, k, v)
    return _proj(attn.reshape(b, s, q.shape[2] * d), lp["wo"], lora, "wo")


def mlp_half(config: LlamaConfig, x, lp, lora=None, enter=None):
    """The MLP block's rank-local half: RMSNorm of ``x``, this rank's
    columns of ``w_gate`` / ``w_up``, SiLU gating, and the product with
    its rows of ``w_down`` — the rank's partial of the block's output."""
    h = rms_norm(x, lp["mlp_norm_scale"], config.norm_eps)
    if enter is not None:
        h = enter(h)
    gate = _proj(h, lp["w_gate"], lora, "w_gate")
    up = _proj(h, lp["w_up"], lora, "w_up")
    return _proj(F.silu(gate) * up, lp["w_down"], lora, "w_down")


def _layer_body(config: LlamaConfig, x, lp, cos, sin, lora=None,
                attention_fn=None, layer_parallel=None):
    """One decoder layer. With ``layer_parallel`` (a sharded step's
    ``parallel.tensor.LayerParallel``) the layer's shards are gathered
    over ``fsdp`` first, and each half runs on the rank's tensor shards
    between the tensor group's entry and exit (an all-reduce of the
    partials)."""
    enter = leave = None
    if layer_parallel is not None:
        lp, lora = layer_parallel.gather(lp, lora)
        enter, leave = layer_parallel.enter, layer_parallel.leave
    partial = attention_half(config, x, lp, cos, sin, lora, attention_fn,
                             enter)
    x = x + (partial if leave is None else leave(partial))
    partial = mlp_half(config, x, lp, lora, enter)
    return x + (partial if leave is None else leave(partial))


def run_layers(config: LlamaConfig, layers: Params, x: torch.Tensor, cos,
               sin, lora: Params | None = None, attention_fn=None,
               layer_parallel=None) -> torch.Tensor:
    """The decoder stack over ``x`` [B, S, E]: ``layers`` holds stacked
    ``[n, ...]`` weights (all of the model's, or a pipeline stage's).

    With ``config.remat`` and autograd recording, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant) with the ``remat_policy``'s
    saved set — the reference's per-layer ``jax.checkpoint``; a
    ``layer_parallel`` gather then runs inside it, so the backward gathers
    again. Without remat, ``layer_parallel.freeing()`` keeps the gathered
    weights out of the saved tensors (they are gathered again where the
    backward reads them). The stacked weights (and the adapter's ``[L,
    ...]`` factors, passed to each layer's checkpoint as inputs) are
    unbound once, so their gradients are stacked once instead of
    scattered per layer."""
    remat = config.remat and torch.is_grad_enabled()
    kwargs = {}
    if remat:
        context_fn = _remat_context(config.remat_policy)
        if context_fn is not None:
            kwargs["context_fn"] = context_fn
    unbound = {name: w.unbind(0) for name, w in layers.items()}
    lora_layers = None
    if lora is not None:
        lora_layers = {target: {key: t.unbind(0) for key, t in parts.items()}
                       for target, parts in lora.items()}
    for layer in range(len(next(iter(unbound.values())))):
        lp = {name: ws[layer] for name, ws in unbound.items()}
        ll = None
        if lora_layers is not None:
            ll = {target: {key: ts[layer] for key, ts in parts.items()}
                  for target, parts in lora_layers.items()}
        if remat:
            x = checkpoint(_layer_body, config, x, lp, cos, sin, ll,
                           attention_fn, layer_parallel, use_reentrant=False,
                           **kwargs)
        elif layer_parallel is not None and torch.is_grad_enabled():
            with layer_parallel.freeing():
                x = _layer_body(config, x, lp, cos, sin, ll, attention_fn,
                                layer_parallel)
        else:
            x = _layer_body(config, x, lp, cos, sin, ll, attention_fn,
                            layer_parallel)
    return x


def hidden_states(config: LlamaConfig, params: Params, tokens: torch.Tensor,
                  positions: torch.Tensor | None = None,
                  lora: Params | None = None,
                  attention_fn=None, layer_parallel=None) -> torch.Tensor:
    """tokens [B, S] -> final-norm hidden [B, S, E] (no lm head):
    the embedding, :func:`run_layers` and the final norm.
    ``attention_fn(q, k, v)`` replaces every layer's causal attention
    (the context-parallel ring and Ulysses, models/llama_cp.py);
    ``layer_parallel`` runs the layers on a rank's shards (the sharded
    step, training/train.py)."""
    x = params["embedding"][tokens].to(config.dtype)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = rope_table(positions, config.head_dim, config.rope_theta)
    x = run_layers(config, params["layers"], x, cos, sin, lora, attention_fn,
                   layer_parallel)
    return rms_norm(x, params["final_norm_scale"], config.norm_eps)


def forward(config: LlamaConfig, params: Params, tokens: torch.Tensor,
            positions: torch.Tensor | None = None,
            lora: Params | None = None, layer_parallel=None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] (f32)."""
    x = hidden_states(config, params, tokens, positions=positions, lora=lora,
                      layer_parallel=layer_parallel)
    return logits_f32(x, lm_head(params))


# -- loss --------------------------------------------------------------------

def _chunk_stats(x_chunk, head, t_chunk, m_chunk):
    logits = logits_f32(x_chunk, head)
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, t_chunk[..., None].long())[..., 0]
    correct = (torch.argmax(logits, dim=-1) == t_chunk).float()
    return ((nll * m_chunk).sum(), (correct * m_chunk).sum(),
            m_chunk.sum())


def chunked_sums(x: torch.Tensor, head: torch.Tensor,
                 targets: torch.Tensor, mask: torch.Tensor | None = None,
                 chunk: int = 512
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sums under :func:`chunked_ce`: (masked nll sum, correct count,
    mask sum), the head product and softmax run per sequence chunk under
    ``torch.utils.checkpoint``. The sequence is padded to a chunk multiple
    with mask 0."""
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    mask = mask.float()
    b, s, _ = x.shape
    chunk = min(chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    loss_sum, correct_sum, count = zero, zero, zero
    remat = torch.is_grad_enabled()
    for c in range(n_chunks):
        part = slice(c * chunk, (c + 1) * chunk)
        args = (x[:, part], head, targets[:, part], mask[:, part])
        if remat:
            stats = checkpoint(_chunk_stats, *args, use_reentrant=False)
        else:
            stats = _chunk_stats(*args)
        loss_sum = loss_sum + stats[0]
        correct_sum = correct_sum + stats[1]
        count = count + stats[2]
    return loss_sum, correct_sum, count


def chunked_ce(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor | None = None, chunk: int = 512
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross-entropy from hidden states without materializing the full
    [B, S, vocab] logits (:func:`chunked_sums`), so the loss holds
    O(B·chunk·V) at a time. Returns (mean_nll, accuracy, token_count)."""
    loss_sum, correct_sum, count = chunked_sums(x, head, targets, mask,
                                                chunk)
    total = torch.clamp_min(count, 1.0)
    return loss_sum / total, correct_sum / total, total


def chunked_loss(config: LlamaConfig, params: Params, tokens: torch.Tensor,
                 targets: torch.Tensor, mask: torch.Tensor | None = None,
                 chunk: int = 512, lora: Params | None = None,
                 layer_parallel=None) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy through :func:`chunked_ce`; returns (loss,
    {"loss", "accuracy", "tokens"})."""
    x = hidden_states(config, params, tokens, lora=lora,
                      layer_parallel=layer_parallel)
    loss, accuracy, total = chunked_ce(x, lm_head(params), targets,
                                       mask=mask, chunk=chunk)
    return loss, {"loss": loss, "accuracy": accuracy, "tokens": total}


def loss_fn(config: LlamaConfig, params: Params, tokens: torch.Tensor,
            targets: torch.Tensor, mask: torch.Tensor | None = None,
            loss_chunk: int = 0, lora: Params | None = None,
            layer_parallel=None) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy; returns (loss, {"loss", "accuracy",
    "tokens"}). ``loss_chunk > 0`` uses the memory-efficient chunked head
    (:func:`chunked_loss`); ``lora`` adds an adapter's deltas;
    ``layer_parallel`` runs the layers on a rank's shards (the sharded
    step)."""
    if loss_chunk:
        return chunked_loss(config, params, tokens, targets, mask=mask,
                            chunk=loss_chunk, lora=lora,
                            layer_parallel=layer_parallel)
    logits = forward(config, params, tokens, lora=lora,
                     layer_parallel=layer_parallel)
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, targets[..., None].long())[..., 0]
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    mask = mask.float()
    total = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / total
    accuracy = ((torch.argmax(logits, dim=-1) == targets).float()
                * mask).sum() / total
    return loss, {"loss": loss, "accuracy": accuracy, "tokens": total}
