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
``experts_down`` ``[L, n_experts, mlp, E_model]``. ``MOE_RULES`` (the
reference's) shard the experts over an ``expert`` mesh axis. The batch
splits over ``data`` x ``fsdp`` only, so the ranks of an expert group hold
the same rows and route them alike; with an :class:`ExpertParallel` each
rank runs only its ``n_experts / n`` experts on those rows and the
group sums the partial outputs (XLA's collectives in the reference,
written out here). The aux loss takes its token fractions over the whole
batch (:meth:`ExpertParallel.frac_tokens`), as the reference's does.

Under phase capture (``utils.profiler.phase``) a layer shows as
``moe.attention``, ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine``, the loss head as ``moe.head``; the same spans inside a
checkpoint's recompute carry ``recompute``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rope, rope_table
from ..utils.profiler import phase
from .llama import (
    LlamaConfig,
    _remat_context,
    chunked_ce,
    lm_head,
    logits_f32,
    normal_init,
)

Params = dict

# sharding rules for the expert-stacked tensors (prepended by users of
# make_moe_rules): experts sharded over 'expert', their matrices over
# fsdp/tensor like the dense ones
MOE_RULES = [
    (r".*experts_gate.*", (None, "expert", "fsdp", "tensor")),
    (r".*experts_up.*", (None, "expert", "fsdp", "tensor")),
    (r".*experts_down.*", (None, "expert", "tensor", "fsdp")),
    (r".*router.*", (None, "fsdp", None)),
]
EXPERT_LEAVES = ("experts_gate", "experts_up", "experts_down")


def make_moe_rules():
    from ..parallel.sharding import DEFAULT_RULES

    return MOE_RULES + list(DEFAULT_RULES)


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


class ExpertParallel:
    """One rank's part of the MoE layers on a mesh with an ``expert``
    axis of size n: the rank runs experts ``[lo, lo + n_experts / n)``
    (:meth:`experts` cuts a layer's leaf that holds them all), the group
    sums the ranks' partial outputs (:meth:`enter` / :meth:`leave`, a
    reduce-scatter then an all-gather, so every expert rank gets the
    same bits), and :meth:`frac_tokens` averages the aux loss's token
    fractions over the batch's parts (``data`` x ``fsdp``)."""

    def __init__(self, config: MoEConfig, mesh):
        from ..parallel.mesh import axes_group
        from ..parallel.sharding import batch_axes, batch_ranks

        names = mesh.mesh_dim_names
        axis = names.index("expert") if "expert" in names else None
        self.size = 1 if axis is None else mesh.size(axis)
        if config.n_experts % self.size:
            raise ValueError(
                f"expert parallelism needs n_experts ({config.n_experts}) "
                f"divisible by the expert axis ({self.size})")
        self.n_experts = config.n_experts
        self.per_rank = config.n_experts // self.size
        self.rank = 0 if axis is None else mesh.get_coordinate()[axis]
        self.lo = self.rank * self.per_rank
        self.group = None if self.size == 1 else mesh.get_group(axis)
        self.batch_parts = batch_ranks(mesh)
        self.batch_group = axes_group(mesh, batch_axes(mesh))[0]

    def experts(self, w: torch.Tensor) -> torch.Tensor:
        """The rank's experts of one layer's ``[E, ...]`` leaf (a leaf
        already cut to them by its ``expert`` placement as is)."""
        if self.size > 1 and w.shape[0] == self.n_experts:
            return w[self.lo:self.lo + self.per_rank]
        return w

    def frac_tokens(self, frac: torch.Tensor) -> torch.Tensor:
        """The global batch's token fraction per expert from the rank's
        (a detached ``[E]``; the parts hold equal rows)."""
        if self.batch_parts == 1:
            return frac
        import torch.distributed as dist

        total = frac.clone()
        dist.all_reduce(total, group=self.batch_group)
        return total / self.batch_parts

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.tensor import enter

        return enter(x, self.group, self.size)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.tensor import leave

        return leave(x, self.group, self.size)


def _route_choices(config: MoEConfig, x: torch.Tensor, router: torch.Tensor,
                   frac_tokens=None) -> tuple[list, torch.Tensor,
                                              torch.Tensor]:
    """The routing of :func:`route` per choice: (the k float32 [B, S, E,
    C] slot masks, the renormalized gates [B, S, k], aux_loss)."""
    b, s, _ = x.shape
    E, k = config.n_experts, config.top_k
    capacity = config.capacity(s)

    router_logits = torch.einsum("bsm,me->bse", x.float(), router.float())
    probs = torch.softmax(router_logits, dim=-1)            # [B, S, E]

    # aux load-balancing loss (Switch): E * sum(fraction_tokens * mean_prob)
    top1 = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top1, E).float().mean(dim=(0, 1))
    if frac_tokens is not None:
        frac = frac_tokens(frac)
    mean_probs = probs.mean(dim=(0, 1))
    aux_loss = E * torch.sum(frac * mean_probs)

    # top-k selection with renormalized gates
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, expert_idx = sorted_probs[..., :k], order[..., :k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    masks = []
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
        masks.append(onehot.float()[:, :, :, None]
                     * cap_onehot[:, :, None, :])
    return masks, gate_vals, aux_loss


def _dispatch_combine(masks: list, gate_vals: torch.Tensor, lo: int = 0,
                      hi: int | None = None) -> tuple:
    """(dispatch, combine) [B, S, E, C] of the experts ``[lo, hi)`` from
    the per-choice masks and gates."""
    dispatch = combine = None
    for choice, mask in enumerate(masks):
        mask = mask[:, :, lo:hi]
        weighted = mask * gate_vals[:, :, choice, None, None]
        dispatch = mask if dispatch is None else dispatch + mask
        combine = weighted if combine is None else combine + weighted
    return dispatch, combine


def route(config: MoEConfig, x: torch.Tensor, router: torch.Tensor,
          frac_tokens=None) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """GShard top-k routing of x [B, S, M]: (dispatch, combine, aux_loss).
    ``dispatch`` [B, S, E, C] is 1 where (token, choice) landed in slot c
    of expert e; ``combine`` carries the renormalized gate there; both are
    float32. Tokens past an expert's capacity C get a zero row.
    ``frac_tokens`` (an :meth:`ExpertParallel.frac_tokens`) turns the aux
    loss's token fractions into the global batch's.

    Ties: ``jax.lax.top_k`` breaks them toward the lower expert, so the
    top k come from a stable descending sort (``torch.topk`` promises no
    order among equal values); ``argmax`` returns the first maximum in
    both packages."""
    with phase("moe.route"):
        masks, gate_vals, aux_loss = _route_choices(config, x, router,
                                                    frac_tokens)
        return (*_dispatch_combine(masks, gate_vals), aux_loss)


def expert_partial(x: torch.Tensor, dispatch: torch.Tensor,
                   combine: torch.Tensor, gate_w: torch.Tensor,
                   up_w: torch.Tensor, down_w: torch.Tensor
                   ) -> torch.Tensor:
    """The float32 output [B, S, M] of the experts whose columns
    ``dispatch`` / ``combine`` [B, S, E', C] and weights ``[E', ...]``
    hold: gather each expert's tokens with the float32 dispatch product,
    run the experts' SwiGLU as one batched product per weight (float32
    accumulation, rounded to x's dtype, as the reference's
    ``preferred_element_type``), and scatter back with the float32
    combine product. Over every expert it is the layer's output; over an
    expert rank's, that rank's partial."""
    b, s, m = x.shape
    n, capacity = dispatch.shape[2], dispatch.shape[3]
    # [E', B, C, M] expert buffers, then [E', B*C, M] for the products
    with phase("moe.dispatch"):
        expert_in = torch.einsum(
            "bsec,bsm->ebcm", dispatch,
            x.float()).to(x.dtype).reshape(n, b * capacity, m)
    with phase("moe.experts"):
        gate_h = torch.matmul(expert_in, gate_w)
        up_h = torch.matmul(expert_in, up_w)
        expert_out = torch.matmul(F.silu(gate_h) * up_h, down_w)
    with phase("moe.combine"):
        return torch.einsum("bsec,ebcm->bsm", combine,
                            expert_out.float().reshape(n, b, capacity, m))


def _moe_mlp(config: MoEConfig, x: torch.Tensor, lp: Params,
             expert_parallel: ExpertParallel | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, M] -> ([B, S, M], aux loss): route, then
    :func:`expert_partial` over every expert. With an
    ``expert_parallel`` group of more than one rank the rank runs its own
    experts on its (the group's) rows and the group sums the partials:
    ``x`` and the gates enter the region (their gradients are summed over
    the group), the routing and the aux loss stay outside it, computed
    alike on every rank."""
    ep = expert_parallel
    experts = [lp[name] for name in EXPERT_LEAVES]
    if ep is None or ep.size == 1:
        if ep is None:
            dispatch, combine, aux_loss = route(config, x, lp["router"])
        else:
            dispatch, combine, aux_loss = route(config, x, lp["router"],
                                                ep.frac_tokens)
        return expert_partial(x, dispatch, combine,
                              *experts).to(x.dtype), aux_loss
    with phase("moe.route"):
        masks, gate_vals, aux_loss = _route_choices(config, x, lp["router"],
                                                    ep.frac_tokens)
        dispatch, combine = _dispatch_combine(
            masks, ep.enter(gate_vals), ep.lo, ep.lo + ep.per_rank)
    partial = expert_partial(ep.enter(x), dispatch, combine,
                             *(ep.experts(w) for w in experts))
    return ep.leave(partial).to(x.dtype), aux_loss


def _layer_body(config: MoEConfig, x, lp, cos, sin, expert_parallel=None):
    b, s, _ = x.shape
    with phase("moe.attention"):
        h = rms_norm(x, lp["attn_norm_scale"], config.norm_eps)
        q = (h @ lp["wq"]).reshape(b, s, config.n_heads, config.head_dim)
        k = (h @ lp["wk"]).reshape(b, s, config.n_kv_heads, config.head_dim)
        v = (h @ lp["wv"]).reshape(b, s, config.n_kv_heads, config.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attention(q, k, v, causal=True, impl=config.attention_impl)
        x = x + attn.reshape(b, s, config.qkv_dim) @ lp["wo"]
    h2 = rms_norm(x, lp["mlp_norm_scale"], config.norm_eps)
    moe_out, aux = _moe_mlp(config, h2, lp, expert_parallel)
    return x + moe_out, aux


def hidden_states(config: MoEConfig, params: Params, tokens: torch.Tensor,
                  expert_parallel: ExpertParallel | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final-norm hidden [B, S, E], aux loss): the mean
    of the layers' aux losses. With ``config.remat`` and autograd
    recording, each layer runs under ``torch.utils.checkpoint`` with the
    ``remat_policy``'s saved set, as models/llama.py does.
    ``expert_parallel``: the rank's part of an expert group (the
    layers' expert leaves may hold the rank's experts only)."""
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
                                expert_parallel, use_reentrant=False,
                                **kwargs)
        else:
            x, aux = _layer_body(config, x, lp, cos, sin, expert_parallel)
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
            loss_chunk: int = 0,
            expert_parallel: ExpertParallel | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Cross-entropy plus ``router_aux_weight`` times the aux loss; returns
    (loss, {"loss", "ce_loss", "aux_loss", "accuracy"}) on both paths.
    ``loss_chunk > 0`` runs the head through llama's ``chunked_ce``, so
    the full [B, S, vocab] logits never exist. On a mesh
    (``expert_parallel``) ``tokens`` are the rank's rows: the mean of the
    ranks' losses (and aux losses) is the global batch's, since every
    rank's aux takes the global token fractions and is linear in its own
    mean router probabilities."""
    x, aux_loss = hidden_states(config, params, tokens, expert_parallel)
    with phase("moe.head"):
        if loss_chunk:
            ce, accuracy, _ = chunked_ce(x, lm_head(params), targets,
                                         mask=mask, chunk=loss_chunk)
        else:
            logits = logits_f32(x, lm_head(params))
            log_probs = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(log_probs, -1,
                                targets[..., None].long())[..., 0]
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
