"""Tensor parallelism over a mesh's ``tensor`` axis, and the per-layer
``fsdp`` gather of the sharded step — the collectives that XLA inserts for
the reference's rule table (``mlrun_tpu/parallel/sharding.py``), written
out.

A Llama layer on a ``tensor`` rank (models/llama.py ``attention_half`` /
``mlp_half``):

- ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up`` are split on their
  output dim (column-parallel): the rank computes its own heads' q/k/v
  and its slice of the MLP from the replicated input;
- attention runs over the rank's heads alone (the card's flash kernels);
- ``wo`` / ``w_down`` are split on their input dim (row-parallel): their
  products are partial sums, all-reduced over the tensor group.

A LoRA adapter (reference rules: ``lora_a`` replicated on ``tensor``,
``lora_b`` split on its output dim) is gathered whole and cut per half
(:func:`adapter_half`); its gradients are partials over the tensor ranks
and are summed there.

Two autograd pairs carry that: :func:`enter` (identity forward, all-reduce
of the input's gradient backward) on the replicated input of a half, and
:func:`leave` (all-reduce forward, identity backward) on its partial
output. Every all-reduce here is a reduce-scatter then an all-gather, so
each element is summed once and every rank gets its bits: the residual
stream stays identical on the tensor ranks.

The ``fsdp`` (and any other non-``tensor``) shards of a layer's leaves
are gathered inside the layer (:meth:`LayerParallel.gather`) and dropped
after it; the gather's backward reduce-scatters the layer's gradient
over the batch axes as soon as it is complete (``sharding.reduce_part``),
so a rank holds one layer gathered at a time, besides its shards.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from .sharding import batch_axes, reduce_part


def all_reduce_same_bits(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The sum of ``x`` over the ``size`` ranks of ``group`` as a new
    tensor: a reduce-scatter of the flattened tensor then an all-gather,
    so every rank receives the same bits."""
    flat = x.reshape(-1)
    n = flat.numel()
    piece = -(-n // size)
    if piece * size != n:
        flat = torch.nn.functional.pad(flat, (0, piece * size - n))
    part = flat.new_empty(piece)
    dist.reduce_scatter_tensor(part, flat.contiguous(), group=group)
    out = flat.new_empty(piece * size)
    dist.all_gather_into_tensor(out, part, group=group)
    return out[:n].view(x.shape)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_same_bits(grad, ctx.group, ctx.size), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        return all_reduce_same_bits(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def enter(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The entry of a region whose ranks each compute a partial of one
    result from the same ``x``: identity forward; backward, the sum of
    the ranks' input gradients (:func:`all_reduce_same_bits`)."""
    if size == 1:
        return x
    return _Enter.apply(x, group, size)


def leave(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The exit of such a region: the sum of the ranks' partials
    (:func:`all_reduce_same_bits`) forward; identity backward."""
    if size == 1:
        return x
    return _Leave.apply(x, group, size)


class LeafComm:
    """How one leaf (or one layer's slice of a stacked leaf) moves between
    a rank's shard and the step: ``gather`` all-gathers the shard over the
    mesh axes ``gather_axes`` (indices, in reverse mesh order: the first
    axis cuts outermost); ``reduce`` turns the step's gradient into the
    rank's part of the mean over ``ranks`` batch shards, summed over the
    axes ``over`` (``sharding.reduce_part``; ``whole``: the axes along
    which the gradient covers the whole leaf)."""

    def __init__(self, mesh, placements, gather_axes, over, whole, ranks):
        self.mesh, self.placements = mesh, tuple(placements)
        self.gather_axes = tuple(a for a in gather_axes
                                 if mesh.size(a) > 1)
        self.over, self.whole, self.ranks = tuple(over), tuple(whole), ranks

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        out = local
        for axis in reversed(self.gather_axes):
            size = self.mesh.size(axis)
            dim = self.placements[axis].dim
            buf = out.new_empty(size * out.numel())
            dist.all_gather_into_tensor(buf, out.contiguous().view(-1),
                                        group=self.mesh.get_group(axis))
            parts = buf.view((size,) + tuple(out.shape))
            out = parts.reshape((-1,) + tuple(out.shape[1:])) if dim == 0 \
                else torch.cat(parts.unbind(0), dim=dim)
        return out

    def reduce(self, grad: torch.Tensor) -> torch.Tensor:
        return reduce_part(grad, self.mesh, self.placements, self.ranks,
                           self.over, self.whole)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, comm: LeafComm):
        ctx.comm = comm
        return comm.gather(local)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.reduce(grad.contiguous()), None


def gathered(local: torch.Tensor, comm: LeafComm) -> torch.Tensor:
    """``comm.gather(local)`` under autograd: its backward is
    ``comm.reduce``. A leaf with nothing to gather and nothing to reduce
    passes through as is."""
    if not comm.gather_axes and not (local.requires_grad and (
            comm.ranks != 1 or any(comm.mesh.size(a) > 1
                                   for a in comm.over))):
        return local
    return _Gather.apply(local, comm)


def _layer_dim(placement):
    """A stacked leaf's placement on one layer's slice (its layer dim
    unbound)."""
    from torch.distributed.tensor import Shard

    if isinstance(placement, Shard):
        if placement.dim == 0:
            raise ValueError("the sharded step gathers layer by layer: a "
                             "layer leaf's layer dim must not be sharded")
        return Shard(placement.dim - 1)
    return placement


# the tensor axis' layout of a Llama layer under the reference's rules:
# output-dim (column) sharded projections, input-dim (row) sharded ones,
# the rest replicated — the halves' arithmetic assumes exactly this
_COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")
_ROW = ("wo", "w_down")


def tensor_shard(name: str, w: torch.Tensor, t: int, tensor: int):
    """Rank ``t``'s shard of one layer's leaf ``name`` (unstacked) on a
    tensor axis of size ``tensor``, as the rules place it: the columns of
    a column-parallel projection, the rows of a row-parallel one, any
    other leaf whole."""
    if name in _COLUMN:
        n = w.shape[-1] // tensor
        return w[..., t * n:(t + 1) * n]
    if name in _ROW:
        n = w.shape[-2] // tensor
        return w[..., t * n:(t + 1) * n, :]
    return w


def adapter_half(target: str, parts: dict, t: int, tensor: int) -> dict:
    """Rank ``t``'s half of one layer's adapter of ``target`` (whole
    ``lora_a`` [in, r], ``lora_b`` [r, out], ``scaling``) on a tensor axis
    of size ``tensor``: a column-parallel target keeps its output columns
    of ``lora_b`` (its delta is the rank's columns of the whole delta), a
    row-parallel one its input rows of ``lora_a`` (its delta is a partial
    sum, like the base product's)."""
    parts = dict(parts)
    if target in _ROW:
        parts["lora_a"] = tensor_shard(target, parts["lora_a"], t, tensor)
    elif target in _COLUMN:
        parts["lora_b"] = tensor_shard(target, parts["lora_b"], t, tensor)
    return parts


class LayerParallel:
    """One rank's view of the layers of a sharded step (models/llama.py
    ``run_layers(layer_parallel=)``). ``layers`` / ``lora`` hold the
    stacked DTensor leaves of the model's (or adapter's) layers; each
    layer's slices are gathered over every sharding axis but ``tensor``
    and their gradients reduced over the batch axes ``data`` x ``fsdp``
    (divided by ``ranks``)."""

    def __init__(self, mesh, layers: dict, lora: dict | None, ranks: int):
        from torch.distributed.tensor import Replicate, Shard

        names = mesh.mesh_dim_names
        self.mesh = mesh
        tensor = names.index("tensor") if "tensor" in names else None
        self.tensor_size = 1 if tensor is None else mesh.size(tensor)
        batch = batch_axes(mesh)

        def comm(placements, adapter=False):
            placements = [_layer_dim(p) for p in placements]
            if adapter and self.tensor_size > 1:
                # an adapter leaf is gathered whole and cut by the halves
                # (gather): its gradient is a partial over the tensor ranks
                gather = [a for a, p in enumerate(placements)
                          if isinstance(p, Shard)]
                return LeafComm(mesh, placements, gather, batch + (tensor,),
                                range(mesh.ndim), ranks)
            gather = [a for a, p in enumerate(placements)
                      if isinstance(p, Shard) and a != tensor]
            return LeafComm(mesh, placements, gather, batch, batch, ranks)

        if self.tensor_size > 1:
            for name, leaf in layers.items():
                on_tensor = leaf.placements[tensor]
                dim = leaf.dim() - (1 if name in _COLUMN else 2)
                want = Shard(dim) if name in _COLUMN + _ROW else Replicate()
                if on_tensor != want:
                    raise ValueError(
                        f"tensor parallelism needs layers/{name} placed "
                        f"{want} on the tensor axis (got {on_tensor})")
            self.group = mesh.get_group(tensor)
            self.tensor_rank = mesh.get_coordinate()[tensor]
        else:
            self.group, self.tensor_rank = None, 0
        self.layers = {name: comm(leaf.placements)
                       for name, leaf in layers.items()}
        self.lora = None if lora is None else {
            target: {key: comm(leaf.placements, adapter=True)
                     for key, leaf in parts.items()}
            for target, parts in lora.items()}
        self._saved = None   # storage -> regather, inside freeing()

    def _gather(self, local, comm: LeafComm):
        out = gathered(local, comm)
        if self._saved is not None and comm.gather_axes:
            self._saved[out.untyped_storage().data_ptr()] = (
                lambda: comm.gather(local.detach()))
        return out

    def gather(self, lp: dict, lora: dict | None):
        """One layer's slices gathered (differentiably) over ``fsdp``. On
        a tensor axis an adapter is gathered whole and cut to the rank's
        half: a column-parallel target's ``lora_b`` to the rank's output
        columns, so its delta is the rank's columns of the whole delta; a
        row-parallel target's ``lora_a`` to the rank's input rows, so its
        delta is a partial sum that joins the base product's partial
        before the tensor all-reduce (added after it, on every rank, it
        would count ``tensor`` times)."""
        lp = {name: self._gather(t, self.layers[name])
              for name, t in lp.items()}
        if lora is not None:
            lora = {target: {key: self._gather(t, self.lora[target][key])
                             for key, t in parts.items()}
                    for target, parts in lora.items()}
            if self.tensor_size > 1:
                lora = {target: adapter_half(target, parts,
                                             self.tensor_rank,
                                             self.tensor_size)
                        for target, parts in lora.items()}
        return lp, lora

    def enter(self, x):
        return enter(x, self.group, self.tensor_size)

    def leave(self, x):
        return leave(x, self.group, self.tensor_size)

    @contextlib.contextmanager
    def freeing(self):
        """Keep this layer's gathered weights out of autograd's saved
        tensors: an op that saves one saves where it lies in the gathered
        storage instead, and the backward gathers it again when it reads
        it (the remat path gets the same from its checkpoint)."""
        saved = self._saved = {}

        def pack(t):
            regather = saved.get(t.untyped_storage().data_ptr()) \
                if t.layout == torch.strided else None
            if regather is None:
                return t
            return (_Regathered, regather, t.storage_offset(),
                    tuple(t.shape), tuple(t.stride()))

        def unpack(packed):
            if not (isinstance(packed, tuple) and packed
                    and packed[0] is _Regathered):
                return packed
            _, regather, offset, shape, stride = packed
            return regather().as_strided(shape, stride, offset)

        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                yield
        finally:
            self._saved = None


class _Regathered:
    """Marker of a saved tensor that the backward gathers again."""


def check_divisible(config, tensor: int):
    """The tensor axis must split the heads, the kv heads and the MLP
    evenly: a rank computes whole heads, and GQA pairs each rank's q heads
    with its own kv heads (no kv head is repeated across ranks)."""
    if tensor <= 1:
        return
    for what, n in (("n_kv_heads", config.n_kv_heads),
                    ("n_heads", config.n_heads),
                    ("mlp_dim", config.mlp_dim)):
        if n % tensor:
            raise ValueError(
                f"tensor parallelism needs {what} ({n}) divisible by the "
                f"tensor axis ({tensor})")
