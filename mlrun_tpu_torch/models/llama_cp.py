"""Context-parallel Llama training — the sequence sharded inside the train
step; counterpart of ``mlrun_tpu/models/llama_cp.py``.

Each rank of a ``seq`` (or ``data`` x ``seq``) mesh takes its batch rows
and its sequence shard of the global [B, S] batch, runs the decoder with
rotary positions at the shard's global offset and every layer's attention
replaced by ring attention (ops/ring_attention.py) or Ulysses
(ops/ulysses.py) over the ``seq`` group, and returns its share of the
global mean loss. The params stay replicated: the shares' gradients,
summed over every rank of the mesh, are the loss's gradient (the ring's
backward carries each rank's part of dk/dv to the shard's owner).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.attention import _repeat_kv
from ..ops.ring_attention import ring_attention
from ..ops.ulysses import ulysses_attention
from ..parallel.sharding import local_part, placements_for
from .llama import LlamaConfig, Params, hidden_states, lm_head, logits_f32


def _cp_hidden(config: LlamaConfig, params: Params, tokens: torch.Tensor,
               group, shard: int, attn_impl: str,
               lora: Params | None = None) -> torch.Tensor:
    """This rank's [B, s, E] final-norm hidden states for its sequence
    shard ``shard`` of ``tokens`` [B, s]."""
    s_local = tokens.shape[1]
    positions = shard * s_local + torch.arange(s_local, device=tokens.device)
    if attn_impl == "ring":
        def attn_fn(q, k, v):
            return ring_attention(q, k, v, group)
    elif attn_impl == "ulysses":
        def attn_fn(q, k, v):
            n_rep = q.shape[2] // k.shape[2]
            return ulysses_attention(q, _repeat_kv(k, n_rep),
                                     _repeat_kv(v, n_rep), group)
    else:
        raise ValueError(f"unknown cp attention impl '{attn_impl}'")
    return hidden_states(config, params, tokens, positions=positions,
                         lora=lora, attention_fn=attn_fn)


def make_context_parallel_loss(config: LlamaConfig, mesh,
                               seq_axis: str = "seq",
                               attn_impl: str = "ring",
                               data_axes: tuple | None = None):
    """Build ``loss(params, tokens, targets, lora=None) -> (share,
    metrics)``: tokens/targets the global [B, S] batch, the batch rows
    split over ``data_axes`` and the sequence over ``seq_axis``. ``share``
    is this rank's differentiable part of the global mean loss (the shares
    sum to it); ``metrics`` holds the global ``loss`` (all-reduced,
    detached) and ``tokens``. Every rank of the mesh calls it together."""
    data_axes = tuple(data_axes or ())
    spec = (data_axes or None, seq_axis)
    placements = placements_for(spec, mesh)
    group = mesh.get_group(seq_axis)

    def loss(params, tokens, targets, lora=None):
        count = tokens.numel()
        local_tokens = local_part(tokens, mesh, placements)
        local_targets = local_part(targets, mesh, placements)
        x = _cp_hidden(config, params, local_tokens, group,
                       mesh.get_local_rank(seq_axis), attn_impl, lora=lora)
        log_probs = torch.log_softmax(logits_f32(x, lm_head(params)), dim=-1)
        nll = -torch.gather(log_probs, -1,
                            local_targets[..., None].long())[..., 0]
        share = nll.sum() / count
        total = share.detach().clone()
        dist.all_reduce(total)
        return share, {"loss": total,
                       "tokens": torch.tensor(float(count),
                                              device=total.device)}

    return loss


def make_cp_train_step(config: LlamaConfig, mesh, optimizer,
                       seq_axis: str = "seq", attn_impl: str = "ring",
                       lora_rank: int = 0, lora_alpha: float = 32.0,
                       grad_accum: int = 1):
    """The context-parallel train step, full fine-tune or LoRA (the
    adapter's leaves are the trained tree), with gradient accumulation:
    ``step(params, lora, opt_state, tokens, targets) -> (params, lora,
    opt_state, metrics)``, updating in place. A mesh with an active
    ``data`` axis splits the batch over it too. The gradients are summed
    over every rank (the params are replicated) before the optimizer;
    ``step.compute_grads(params, tokens, targets, lora=None)`` gives them
    without updating. ``lora_alpha`` is the adapter's (it is built by
    ``init_train_state``)."""
    from ..training.train import accumulate_grads, tree_leaves
    from ..parallel.mesh import mesh_shape

    is_lora = lora_rank > 0
    accum = max(1, grad_accum)
    data_axes = tuple(a for a in ("data",)
                      if mesh_shape(mesh).get(a, 1) > 1)
    loss_fn = make_context_parallel_loss(config, mesh, seq_axis, attn_impl,
                                         data_axes=data_axes or None)

    def local_grads(params, lora, tokens, targets):
        share, metrics = loss_fn(params, tokens, targets, lora=lora)
        leaves = tree_leaves(lora if is_lora else params)
        return list(torch.autograd.grad(share, leaves)), metrics

    def compute_grads(params, tokens, targets, lora=None):
        # the global batch, so micro-batches are global row blocks
        if accum > 1:
            grads, metrics = accumulate_grads(
                lambda t, g: local_grads(params, lora, t, g), tokens,
                targets, accum)
        else:
            grads, metrics = local_grads(params, lora, tokens, targets)
        grads = [grad.contiguous() for grad in grads]   # for NCCL
        for grad in grads:
            dist.all_reduce(grad)
        return grads, dict(metrics)

    def step(params, lora, opt_state, tokens, targets):
        grads, metrics = compute_grads(params, tokens, targets, lora)
        metrics["grad_norm"] = optimizer.update(
            grads, opt_state, lora if is_lora else params)
        return params, lora, opt_state, metrics

    step.compute_grads = compute_grads
    return step
