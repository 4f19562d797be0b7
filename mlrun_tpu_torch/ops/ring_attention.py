"""Ring attention — context parallelism over a ``seq`` process group;
counterpart of ``mlrun_tpu/ops/ring_attention.py``.

Each rank holds one shard of the sequence (q, k and v alike; shard ``r``
is positions ``r*S .. (r+1)*S - 1``). The k/v shard rotates around the
ring (``batch_isend_irecv`` to the next rank); at hop ``t`` rank ``r``
holds the shard of rank ``(r - t) % P``. Causal attention needs three
cases, by the shard indices (q ``r``, kv ``src``):

- ``src < r``, an earlier shard: the flash forward without the mask;
- ``src == r``, the diagonal: the flash forward with the causal mask;
- ``src > r``, a later shard: nothing. The reference computes it and
  folds it in with weight ``exp(NEG_INF - m) = 0``, so skipping is exact.

Hops fold into a float32 output and its log-sum-exp through
``merge_softmax_states``. The backward runs the flash backward per hop
with the GLOBAL ``o`` and ``lse``, which makes each hop's dq, dk and dv
exact partials: dq adds up in float32 on its rank, dk/dv in float32
accumulators that travel with their shard around the ring and one more
hop home. The flash forward and backward are the port's kernels on CUDA
tensors and their plain versions on the CPU.

The hop schedule lives in :func:`ring_forward` / :func:`ring_backward`,
which take the shard held at each hop from a callable: the process group
supplies a rotation (:func:`ring_attention`), and :func:`ring_hops_fwd`
/ :func:`ring_hops_bwd` run every rank's hops in one process, in ring
order (the tests and the chip check hold that against the full
sequence).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .attention import _flash_bwd_op, _flash_fwd_op
from .paged_attention import merge_softmax_states


def hop_source(rank: int, hop: int, world: int) -> int:
    """The kv shard rank ``rank`` holds at hop ``hop``."""
    return (rank - hop) % world


def ring_forward(q, shard_at: Callable, rank: int, world: int):
    """(o in q's dtype, lse [B, H, S] f32) of q, rank ``rank``'s shard,
    against every kv shard it attends. ``shard_at(hop)`` returns the
    (k, v) held at that hop and is called for every hop in order."""
    o = lse = None
    for hop in range(world):
        k, v = shard_at(hop)
        src = hop_source(rank, hop, world)
        if src > rank:
            continue
        o_h, lse_h = _flash_fwd_op(q, k, v, src == rank)
        if o is None:
            o, lse = o_h.float(), lse_h
        else:
            o = merge_softmax_states(o, lse, o_h, lse_h)
            lse = torch.logaddexp(lse, lse_h)
    return o.to(q.dtype), lse


def ring_backward(q, o, lse, g, shard_at: Callable, deposit: Callable,
                  rank: int, world: int):
    """dq of rank ``rank``'s shard; every hop's dk/dv partial goes to
    ``deposit(hop, dk, dv)``. ``o``/``lse`` are the ring forward's
    (global) output and log-sum-exp."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for hop in range(world):
        k, v = shard_at(hop)
        src = hop_source(rank, hop, world)
        if src > rank:
            continue
        dq_h, dk_h, dv_h = _flash_bwd_op(q, k, v, o, lse, g, src == rank)
        dq += dq_h.float()
        deposit(hop, dk_h, dv_h)
    return dq.to(q.dtype)


def ring_hops_fwd(qs: list, ks: list, vs: list) -> list:
    """Every rank's :func:`ring_forward` in one process, rank by rank:
    shard lists in, [(o, lse)] per rank out."""
    world = len(qs)
    return [ring_forward(q, lambda hop, r=rank: (
        ks[hop_source(r, hop, world)], vs[hop_source(r, hop, world)]),
        rank, world) for rank, q in enumerate(qs)]


def ring_hops_bwd(qs, ks, vs, os_, lses, gs) -> tuple[list, list, list]:
    """Every rank's :func:`ring_backward` in one process: (dqs, dks,
    dvs) per shard, dk/dv summed over the hops in float32 like the
    travelling accumulators of the process-group version."""
    world = len(qs)
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for k in ks]
    dvs = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
           for v in vs]
    dqs = []
    for rank in range(world):
        def shard_at(hop, r=rank):
            src = hop_source(r, hop, world)
            return ks[src], vs[src]

        def deposit(hop, dk, dv, r=rank):
            src = hop_source(r, hop, world)
            dks[src] += dk.float()
            dvs[src] += dv.float()

        dqs.append(ring_backward(qs[rank], os_[rank], lses[rank], gs[rank],
                                 shard_at, deposit, rank, world))
    return (dqs, [d.to(k.dtype) for d, k in zip(dks, ks)],
            [d.to(v.dtype) for d, v in zip(dvs, vs)])


class _Rotation:
    """Tensors passed around the ring of ``group``: ``step()`` sends the
    current ones to the next rank and takes the previous rank's."""

    def __init__(self, tensors: list, group):
        self.tensors = tensors
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        self.next = dist.get_global_rank(group, (rank + 1) % world)
        self.prev = dist.get_global_rank(group, (rank - 1) % world)
        self.group = group

    def step(self):
        received = [torch.empty_like(t) for t in self.tensors]
        ops = [dist.P2POp(dist.isend, t, self.next, self.group)
               for t in self.tensors]
        ops += [dist.P2POp(dist.irecv, t, self.prev, self.group)
                for t in received]
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        self.tensors = received


class RingAttention(torch.autograd.Function):
    """Exact causal attention of this rank's sequence shard against the
    whole sequence of the ``seq`` group (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        ring = _Rotation([k, v], group)

        def shard_at(hop):
            if hop:
                ring.step()
            return ring.tensors

        o, lse = ring_forward(q, shard_at, rank, world)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group = group
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        group = ctx.group
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        # dk/dv accumulators travel with their shard
        ring = _Rotation([k, v, torch.zeros(k.shape, dtype=torch.float32,
                                            device=k.device),
                          torch.zeros(v.shape, dtype=torch.float32,
                                      device=v.device)], group)

        def shard_at(hop):
            if hop:
                ring.step()
            return ring.tensors[:2]

        def deposit(hop, dk, dv):
            ring.tensors[2] += dk.float()
            ring.tensors[3] += dv.float()

        dq = ring_backward(q, o, lse, g.contiguous(), shard_at, deposit,
                           rank, world)
        # after the last hop a rank holds the next rank's accumulators:
        # one more hop takes every accumulator home
        home = _Rotation(ring.tensors[2:], group)
        if world > 1:
            home.step()
        dk, dv = home.tensors
        return dq, dk.to(k.dtype), dv.to(v.dtype), None


def ring_attention(q, k, v, group) -> torch.Tensor:
    """Causal attention over a sequence sharded on ``group``: q [B, S, H,
    D], k/v [B, S, H or Hkv, D], this rank's shards. Returns o [B, S, H,
    D]; differentiable."""
    return RingAttention.apply(q, k, v, group)
