"""Ulysses sequence parallelism — all-to-all head/sequence exchange;
counterpart of ``mlrun_tpu/ops/ulysses.py``.

Each rank holds a sequence shard of q/k/v. One ``all_to_all_single`` per
tensor scatters the heads and gathers the sequence, so every rank runs
full-sequence attention (``flash_attention_mlt``: the port's flash
kernels on CUDA tensors) for ``H / P`` heads; a second all-to-all
restores the sequence sharding. Both exchanges are their own adjoint, so
the backward is the same two all-to-alls on the gradients. At world size
1 it is plain flash attention.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .attention import flash_attention_mlt


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` with equal splits of dim 0;
    block ``j`` of rank ``i``'s output is block ``i`` of rank ``j``'s
    input, so the gradient takes the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    # contiguous first: empty_like keeps a permuted tensor's strides, and
    # the collective writes its output as one row-major buffer
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def ulysses_attention(q, k, v, group, causal: bool = True) -> torch.Tensor:
    """Exact attention over a sequence sharded on ``group``: q/k/v local
    shards [B, S_local, H, D] (kv heads already repeated to H; H must
    divide by the group size). Returns [B, S_local, H, D]."""
    world = dist.get_world_size(group)
    b, s_local, h, d = q.shape
    if h % world:
        raise ValueError(
            f"heads {h} not divisible by sequence-parallel size {world}")
    h_per = h // world

    def scatter_heads(x):
        # [B, s, H, D] -> [P(dest), B, s, h', D]; afterwards dim 0 is the
        # source rank, whose rows are its sequence shard
        x = x.reshape(b, s_local, world, h_per, d).permute(2, 0, 1, 3, 4)
        x = _AllToAll.apply(x, group)
        return x.permute(1, 0, 2, 3, 4).reshape(b, world * s_local, h_per, d)

    def gather_heads(x):
        # [B, S, h', D] -> [P(dest), B, s, h', D]; afterwards dim 0 is the
        # head group's owner
        x = x.reshape(b, world, s_local, h_per, d).permute(1, 0, 2, 3, 4)
        x = _AllToAll.apply(x, group)
        return x.permute(1, 2, 0, 3, 4).reshape(b, s_local, h, d)

    out = flash_attention_mlt(scatter_heads(q), scatter_heads(k),
                              scatter_heads(v), causal)
    return gather_heads(out)
