"""Mixture-of-Experts Llama variant in plain PyTorch — counterpart of
``mlrun_tpu/models/moe.py``.

The dense SwiGLU MLP of models/llama.py is replaced by top-k routed
experts whose weights are stacked ``[L, E, ...]``. Routing is GShard's:
top-k with renormalized gates, a static capacity per expert, tokens past
it dropped, and the Switch load-balancing aux loss. Dispatch and combine
are the reference's one-hot products over ``[B, S, E, capacity]`` masks,
in float32.

The param tree is the reference's: Llama's attention leaves plus
``router`` ``[L, E_model, n_experts]`` (float32 whatever ``dtype``) and
``experts_gate`` / ``experts_up`` ``[L, n_experts, E_model, mlp]``,
``experts_down`` ``[L, n_experts, mlp, E_model]``. Sharding the experts
over an ``expert`` mesh axis (the reference's ``MOE_RULES``) waits for
training on many GPUs; on one device the port runs the reference's
single-device computation.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rope, rope_table
from .llama import (
    LlamaConfig,
    _remat_context,
    chunked_ce,
    lm_head,
    logits_f32,
    normal_init,
)

Params = dict


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    def _attn_params(self) -> int:
        return (self.embed_dim * self.qkv_dim
                + 2 * self.embed_dim * self.kv_dim
                + self.qkv_dim * self.embed_dim)

    def param_count(self) -> int:
        embed = self.vocab_size * self.embed_dim
        moe = (self.n_experts * 3 * self.embed_dim * self.mlp_dim
               + self.embed_dim * self.n_experts)
        per_layer = self._attn_params() + moe + 2 * self.embed_dim
        head = 0 if self.tie_embeddings else self.vocab_size * self.embed_dim
        return embed + self.n_layers * per_layer + self.embed_dim + head

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs a token over the ACTIVE params: each token goes
        through ``top_k`` experts, not all ``n_experts`` (the dense formula
        would count every expert and understate MFU)."""
        active_moe = (self.top_k * 3 * self.embed_dim * self.mlp_dim
                      + self.embed_dim * self.n_experts)
        matmul = (self.n_layers * (self._attn_params() + active_moe)
                  + self.vocab_size * self.embed_dim)
        attn_flops = 2 * self.n_layers * seq_len * self.qkv_dim
        return 6.0 * matmul + 6.0 * attn_flops

    def capacity(self, seq_len: int) -> int:
        """Slots a sequence gives each expert (the reference's static
        capacity)."""
        return max(1, int(self.capacity_factor * seq_len * self.top_k
                          / self.n_experts))


def tiny_moe(**overrides) -> MoEConfig:
    return dataclasses.replace(MoEConfig(
        vocab_size=512, n_layers=2, embed_dim=128, n_heads=4, n_kv_heads=2,
        head_dim=32, mlp_dim=128, n_experts=4, top_k=2,
        tie_embeddings=True, remat=False), **overrides)


def mixtral_8x7b_like(**overrides) -> MoEConfig:
    return dataclasses.replace(MoEConfig(
        vocab_size=32000, n_layers=32, embed_dim=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, mlp_dim=14336, n_experts=8, top_k=2,
        rope_theta=1e6), **overrides)


def init_params(config: MoEConfig, generator: torch.Generator,
                device: torch.device | str) -> Params:
    """Random params (normal, scaled by fan_in**-0.5) drawn on ``device``
    from ``generator``, stored in ``config.dtype``; the router is drawn
    the same way and kept in float32, as the reference keeps it."""
    dtype = config.dtype
    e, h, kv, m = (config.embed_dim, config.qkv_dim, config.kv_dim,
                   config.mlp_dim)
    L, E = config.n_layers, config.n_experts
    normal = normal_init(generator, device, dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params: Params = {
        "embedding": normal(e, (config.vocab_size, e)),
        "layers": {
            "attn_norm_scale": ones(L, e),
            "wq": normal(e, (L, e, h)),
            "wk": normal(e, (L, e, kv)),
            "wv": normal(e, (L, e, kv)),
            "wo": normal(h, (L, h, e)),
            "mlp_norm_scale": ones(L, e),
            "router": normal(e, (L, e, E)).float(),
            "experts_gate": normal(e, (L, E, e, m)),
            "experts_up": normal(e, (L, E, e, m)),
            "experts_down": normal(m, (L, E, m, e)),
        },
        "final_norm_scale": ones(e),
    }
    if not config.tie_embeddings:
        params["lm_head"] = normal(e, (e, config.vocab_size))
    return params


def route(config: MoEConfig, x: torch.Tensor, router: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard top-k routing of x [B, S, M]: (dispatch, combine, aux_loss).
    ``dispatch`` [B, S, E, C] is 1 where (token, choice) landed in slot c
    of expert e; ``combine`` carries the renormalized gate there; both are
    float32. Tokens past an expert's capacity C get a zero row.

    Ties: ``jax.lax.top_k`` breaks them toward the lower expert, so the
    top k come from a stable descending sort (``torch.topk`` promises no
    order among equal values); ``argmax`` returns the first maximum in
    both packages."""
    b, s, _ = x.shape
    E, k = config.n_experts, config.top_k
    capacity = config.capacity(s)

    router_logits = torch.einsum("bsm,me->bse", x.float(), router.float())
    probs = torch.softmax(router_logits, dim=-1)            # [B, S, E]

    # aux load-balancing loss (Switch): E * sum(fraction_tokens * mean_prob)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = F.one_hot(top1, E).float().mean(dim=(0, 1))
    mean_probs = probs.mean(dim=(0, 1))
    aux_loss = E * torch.sum(frac_tokens * mean_probs)

    # top-k selection with renormalized gates
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, expert_idx = sorted_probs[..., :k], order[..., :k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    dispatch = x.new_zeros((b, s, E, capacity), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    # running token count per expert, carried across the choice ranks
    counts = torch.zeros((b, E), dtype=torch.int64, device=x.device)
    for choice in range(k):
        onehot = F.one_hot(expert_idx[:, :, choice], E)      # [B, S, E]
        # position in expert = tokens of the same expert before me
        pos = torch.cumsum(onehot, dim=1) - onehot + counts[:, None, :]
        counts = counts + onehot.sum(dim=1)
        my_pos = (pos * onehot).sum(dim=-1)                  # [B, S]
        keep = (my_pos < capacity).float()
        # one_hot raises past the last class where jax.nn.one_hot gives a
        # zero row: clamp, then zero the dropped rows with keep
        cap_onehot = F.one_hot(my_pos.clamp_max(capacity - 1),
                               capacity).float() * keep[..., None]
        mask = onehot.float()[:, :, :, None] * cap_onehot[:, :, None, :]
        dispatch = dispatch + mask
        combine = combine + mask * gate_vals[:, :, choice, None, None]
    return dispatch, combine, aux_loss


def _moe_mlp(config: MoEConfig, x: torch.Tensor, lp: Params
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, M] -> ([B, S, M], aux loss): route, gather each expert's
    tokens with the float32 dispatch product, run the experts' SwiGLU as
    one batched product per weight (float32 accumulation, rounded to x's
    dtype, as the reference's ``preferred_element_type``), and scatter
    back with the float32 combine product."""
    b, s, m = x.shape
    E = config.n_experts
    dispatch, combine, aux_loss = route(config, x, lp["router"])
    capacity = dispatch.shape[-1]
    # [E, B, C, M] expert buffers, then [E, B*C, M] for the batched products
    expert_in = torch.einsum("bsec,bsm->ebcm", dispatch,
                             x.float()).to(x.dtype).reshape(E, b * capacity, m)
    gate_h = torch.matmul(expert_in, lp["experts_gate"])
    up_h = torch.matmul(expert_in, lp["experts_up"])
    expert_out = torch.matmul(F.silu(gate_h) * up_h, lp["experts_down"])
    out = torch.einsum("bsec,ebcm->bsm", combine,
                       expert_out.float().reshape(E, b, capacity, m))
    return out.to(x.dtype), aux_loss


def _layer_body(config: MoEConfig, x, lp, cos, sin):
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm_scale"], config.norm_eps)
    q = (h @ lp["wq"]).reshape(b, s, config.n_heads, config.head_dim)
    k = (h @ lp["wk"]).reshape(b, s, config.n_kv_heads, config.head_dim)
    v = (h @ lp["wv"]).reshape(b, s, config.n_kv_heads, config.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attention(q, k, v, causal=True, impl=config.attention_impl)
    x = x + attn.reshape(b, s, config.qkv_dim) @ lp["wo"]
    h2 = rms_norm(x, lp["mlp_norm_scale"], config.norm_eps)
    moe_out, aux = _moe_mlp(config, h2, lp)
    return x + moe_out, aux


def hidden_states(config: MoEConfig, params: Params, tokens: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final-norm hidden [B, S, E], aux loss): the mean
    of the layers' aux losses. With ``config.remat`` and autograd
    recording, each layer runs under ``torch.utils.checkpoint`` with the
    ``remat_policy``'s saved set, as models/llama.py does."""
    x = params["embedding"][tokens].to(config.dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = rope_table(positions, config.head_dim, config.rope_theta)
    remat = config.remat and torch.is_grad_enabled()
    kwargs = {}
    if remat:
        context_fn = _remat_context(config.remat_policy)
        if context_fn is not None:
            kwargs["context_fn"] = context_fn
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    aux_losses = []
    for layer in range(config.n_layers):
        lp = {name: ws[layer] for name, ws in layers.items()}
        if remat:
            x, aux = checkpoint(_layer_body, config, x, lp, cos, sin,
                                use_reentrant=False, **kwargs)
        else:
            x, aux = _layer_body(config, x, lp, cos, sin)
        aux_losses.append(aux)
    x = rms_norm(x, params["final_norm_scale"], config.norm_eps)
    return x, torch.stack(aux_losses).mean()


def forward(config: MoEConfig, params: Params, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] f32, aux loss)."""
    x, aux = hidden_states(config, params, tokens)
    return logits_f32(x, lm_head(params)), aux


def loss_fn(config: MoEConfig, params: Params, tokens: torch.Tensor,
            targets: torch.Tensor, mask: torch.Tensor | None = None,
            loss_chunk: int = 0) -> tuple[torch.Tensor, dict]:
    """Cross-entropy plus ``router_aux_weight`` times the aux loss; returns
    (loss, {"loss", "ce_loss", "aux_loss", "accuracy"}) on both paths.
    ``loss_chunk > 0`` runs the head through llama's ``chunked_ce``, so
    the full [B, S, vocab] logits never exist."""
    if loss_chunk:
        x, aux_loss = hidden_states(config, params, tokens)
        ce, accuracy, _ = chunked_ce(x, lm_head(params), targets, mask=mask,
                                     chunk=loss_chunk)
    else:
        logits, aux_loss = forward(config, params, tokens)
        log_probs = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(log_probs, -1, targets[..., None].long())[..., 0]
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=targets.device)
        mask = mask.float()
        total = torch.clamp_min(mask.sum(), 1.0)
        ce = (nll * mask).sum() / total
        accuracy = ((torch.argmax(logits, dim=-1) == targets).float()
                    * mask).sum() / total
    loss = ce + config.router_aux_weight * aux_loss
    return loss, {"loss": loss, "ce_loss": ce, "aux_loss": aux_loss,
                  "accuracy": accuracy}
