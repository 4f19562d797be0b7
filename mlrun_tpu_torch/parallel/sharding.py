"""Sharding rules: logical parameter axes -> mesh axes — counterpart of
``mlrun_tpu/parallel/sharding.py``.

Every leaf of a parameter tree (a nested dict of tensors) is matched by
its ``/``-joined path against the reference's rule table and gets a spec:
one mesh axis name (or None) per tensor dim. On a ``DeviceMesh`` a spec
becomes DTensor placements, one per mesh axis: ``Shard(d)`` where the
spec names that axis at tensor dim ``d``, ``Replicate()`` elsewhere. Axes
the mesh lacks, or holds at size 1, are dropped first, as the reference
does, so one table serves every mesh.

The step gathers the DTensor params into plain tensors (:func:`gather`,
or layer by layer in parallel/tensor.py), so no DTensor ever reaches a
kernel launch, runs on the rank's part of the batch (:func:`local_part`)
and brings the gradients back to the params' placements
(:func:`reduce_part`, :func:`reduce_to`). The batch splits over ``data``
x ``fsdp`` only: the ranks of a ``tensor`` or an ``expert`` group hold
the same rows, so their gradients of a replicated leaf are copies, cut
and never summed (models/moe.py's ``MOE_RULES`` put the experts on the
``expert`` axis).
"""

from __future__ import annotations

import re
from typing import Any, Sequence

from .mesh import mesh_shape

# the reference's table for the Llama parameter tree (path -> spec);
# first match wins
DEFAULT_RULES: list[tuple[str, tuple]] = [
    # lora adapters [layers, in, rank] / [layers, rank, out] — before the
    # projection rules (paths look like "wq/lora_a"); rank unsharded
    (r".*lora_a.*", (None, "fsdp", None)),
    (r".*lora_b.*", (None, None, "tensor")),
    (r".*scaling.*", ()),
    # token embedding [vocab, embed]
    (r".*embedding.*", ("fsdp", "tensor")),
    # attention projections, stacked over layers: [layers, embed, heads*hd]
    (r".*(wq|wk|wv).*", (None, "fsdp", "tensor")),
    # attention output [layers, heads*head_dim, embed]
    (r".*wo.*", (None, "tensor", "fsdp")),
    # mlp in/gate [layers, embed, mlp]
    (r".*(w_gate|w_up).*", (None, "fsdp", "tensor")),
    # mlp out [layers, mlp, embed]
    (r".*w_down.*", (None, "tensor", "fsdp")),
    # norms / scales / biases — replicated
    (r".*(norm|scale|bias).*", ()),
    # final head [embed, vocab]
    (r".*lm_head.*", ("tensor", "fsdp")),
]


def _map_with_path(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {key: _map_with_path(fn, value, f"{prefix}{key}/")
                for key, value in tree.items()}
    return fn(prefix[:-1], tree)


def spec_for_path(path: str, rules: Sequence[tuple] | None = None,
                  ndim: int | None = None) -> tuple:
    """The first matching rule's spec, fitted to ``ndim`` (leading axes
    dropped for unstacked leaves, trailing Nones added); ``()`` (replicate)
    when no rule matches."""
    rules = rules if rules is not None else DEFAULT_RULES
    for pattern, spec in rules:
        if re.match(pattern, path, flags=re.IGNORECASE):
            spec = tuple(spec)
            if ndim is not None:
                if len(spec) > ndim:
                    spec = spec[len(spec) - ndim:]
                elif len(spec) < ndim:
                    spec = spec + (None,) * (ndim - len(spec))
            return spec
    return ()


def _filter_spec_to_mesh(spec: tuple, mesh) -> tuple:
    """Drop axis names the mesh doesn't have, or has at size 1, and
    trailing Nones (the reference's filter). ``mesh``: a DeviceMesh or an
    {axis: size} dict."""
    sizes = mesh_shape(mesh)

    def kept(axis):
        return axis in sizes and sizes[axis] > 1

    out = []
    for entry in spec:
        if isinstance(entry, (tuple, list)):
            entry = tuple(a for a in entry if kept(a)) or None
        elif entry is not None and not kept(entry):
            entry = None
        out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _leaf_placements(path: str, leaf, mesh, rules) -> tuple:
    spec = _filter_spec_to_mesh(spec_for_path(path, rules, ndim=leaf.dim()),
                                mesh)
    return placements_for(spec, mesh)


def tree_pspecs(tree: Any, mesh, rules: Sequence[tuple] | None = None) -> Any:
    """The filtered spec of every leaf (the reference's PartitionSpecs as
    tuples)."""
    return _map_with_path(
        lambda path, leaf: _filter_spec_to_mesh(
            spec_for_path(path, rules, ndim=leaf.dim()), mesh), tree)


def placements_for(spec: tuple, mesh) -> tuple:
    """DTensor placements of a filtered spec on ``mesh``: per mesh axis,
    ``Shard(d)`` for the tensor dim ``d`` naming it, else
    ``Replicate()``. Two axes on one dim shard it in mesh-axis order."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {}
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                dims[axis] = dim
    return tuple(Shard(dims[axis]) if axis in dims else Replicate()
                 for axis in mesh.mesh_dim_names)


class Placements(tuple):
    """A leaf's DTensor placements (a tuple, one per mesh axis) that also
    carries its ``mesh``, as the reference's ``NamedSharding`` does: what
    :func:`tree_shardings` returns, and what
    ``load_hf_weights_into_llama(shardings=)`` places a leaf by."""

    def __new__(cls, placements, mesh=None):
        out = super().__new__(cls, placements)
        out.mesh = mesh
        return out


def tree_shardings(tree: Any, mesh, rules: Sequence[tuple] | None = None
                   ) -> Any:
    """The DTensor placements of every leaf on ``mesh`` (each a
    :class:`Placements`)."""
    return _map_with_path(
        lambda path, leaf: Placements(
            _leaf_placements(path, leaf, mesh, rules), mesh), tree)


def shard_pytree(tree: Any, mesh, rules: Sequence[tuple] | None = None) -> Any:
    """Place a tree of full tensors (the same on every rank) onto the mesh
    as DTensors with rule-derived placements (detached: the step
    differentiates the gathered tensors, not these)."""
    from torch.distributed.tensor import distribute_tensor

    return _map_with_path(
        lambda path, leaf: distribute_tensor(
            leaf.detach(), mesh, _leaf_placements(path, leaf, mesh, rules)),
        tree)


def batch_spec(mesh, seq_axis: str | None = None) -> tuple:
    """Spec of [batch, seq, ...] data: batch over the data-ish axes,
    optionally the sequence over ``seq_axis`` (context parallelism)."""
    sizes = mesh_shape(mesh)
    data_axes = tuple(a for a in ("data", "fsdp") if sizes.get(a, 1) > 1)
    batch_axes = data_axes if data_axes else None
    if seq_axis and sizes.get(seq_axis, 1) > 1:
        return (batch_axes, seq_axis)
    return (batch_axes,)


def batch_sharding(mesh, seq_axis: str | None = None) -> tuple:
    """DTensor placements of [batch, seq, ...] data on ``mesh``."""
    return placements_for(batch_spec(mesh, seq_axis), mesh)


class ShardingRules:
    """User-extensible rule table attached to a trainer."""

    def __init__(self, rules: Sequence[tuple] | None = None):
        self.rules = list(rules if rules is not None else DEFAULT_RULES)

    def add(self, pattern: str, spec: tuple, first: bool = True):
        if first:
            self.rules.insert(0, (pattern, spec))
        else:
            self.rules.append((pattern, spec))
        return self

    def shardings(self, tree, mesh):
        return tree_shardings(tree, mesh, self.rules)

    def pspecs(self, tree, mesh):
        return tree_pspecs(tree, mesh, self.rules)


# -- the step's collectives ---------------------------------------------------

def gather(leaf):
    """The full tensor of a DTensor leaf (an all-gather over the axes that
    shard it), a plain tensor as is."""
    from torch.distributed.tensor import DTensor

    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def local_part(x, mesh, placements, accum: int = 1):
    """This rank's part of a global tensor placed by ``placements``: a
    DTensor's local tensor, or the slice of a plain tensor at this rank's
    mesh coordinate (no communication). A sharded dim must divide
    evenly. With ``accum`` > 1 a plain batch is first split into
    ``accum`` micro-batches along dim 0 and the rank's part of each is
    kept, in order (the reference's gradient accumulation splits the
    global batch before sharding it), so the rank's ``accum`` equal
    parts are its rows of each micro-batch."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.to_local()
    coordinate = mesh.get_coordinate()
    if accum > 1 and x.shape[0] % accum == 0:
        import torch

        return torch.cat([_part_at(part, mesh, placements, coordinate)
                          for part in x.chunk(accum)])
    return _part_at(x, mesh, placements, coordinate)


def _part_at(x, mesh, placements, coordinate):
    """The slice of ``x`` held at mesh ``coordinate``: each ``Shard(d)``
    cut in mesh-axis order."""
    from torch.distributed.tensor import Shard

    for axis, placement in enumerate(placements):
        if not isinstance(placement, Shard):
            continue
        size = mesh.size(axis)
        dim = placement.dim
        if x.shape[dim] % size:
            raise ValueError(
                f"dim {dim} of size {x.shape[dim]} does not split evenly "
                f"over mesh axis '{mesh.mesh_dim_names[axis]}' of size "
                f"{size}")
        part = x.shape[dim] // size
        x = x.narrow(dim, coordinate[axis] * part, part)
    return x


def reduce_part(grad, mesh, placements, ranks: int, over=None,
                whole=None):
    """The mean over the batch shards of a gradient, as this rank's part
    of a leaf placed by ``placements``: ``grad`` summed over the ranks
    that differ from this one only on the mesh axes ``over`` (indices;
    default every axis), divided by ``ranks``, cut to the rank's part.
    ``grad`` covers the whole leaf along the axes ``whole`` (default
    every axis) and this rank's part along the others (a tensor rank's
    shard of a projection); along whole axes outside ``over`` (a tensor
    axis whose ranks all hold the same gradient) it is cut without a
    sum.

    One reduce-scatter over the ``over`` group does the sum: each member's
    part is laid out end to end in group-rank order, so each element is
    summed once and lands on the ranks that hold it with one bit pattern.
    A part replicated over axes of ``over`` is split into one piece per
    copy, and an all-gather over each such axis (copies, no arithmetic)
    puts it back together. The group moves a reduce-scatter's bytes for
    a leaf sharded on every member, an all-reduce's for a replicated
    one."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from .mesh import axes_group

    axes = range(mesh.ndim)
    over = tuple(axes) if over is None else tuple(over)
    whole = tuple(axes) if whole is None else tuple(whole)
    coordinate = list(mesh.get_coordinate())
    grad = _part_at(grad, mesh, [p if a in whole and a not in over
                                 else Replicate()
                                 for a, p in enumerate(placements)],
                    coordinate)
    placements = [p if a in over else Replicate()
                  for a, p in enumerate(placements)]
    group, members = axes_group(mesh, over)
    copied = [a for a in over if not isinstance(placements[a], Shard)
              and mesh.size(a) > 1]
    copies = 1
    for axis in copied:
        copies *= mesh.size(axis)
    shape = _part_at(grad, mesh, placements, coordinate).shape
    count = shape.numel()
    piece = -(-count // copies)
    pieces = []
    layout = mesh.mesh
    for rank in members:
        where = [int(c) for c in (layout == rank).nonzero()[0]]
        index = 0   # the member's copy, row-major over the copied axes
        for axis in copied:
            index = index * mesh.size(axis) + where[axis]
        flat = _part_at(grad, mesh, placements, where).reshape(-1)
        flat = flat[index * piece:(index + 1) * piece]
        if flat.numel() < piece:
            flat = torch.nn.functional.pad(flat, (0, piece - flat.numel()))
        pieces.append(flat)
    if len(members) == 1:
        part = pieces[0].clone()
    else:
        part = grad.new_empty(piece)
        dist.reduce_scatter_tensor(part, torch.cat(pieces), group=group)
    part.div_(ranks)
    for axis in reversed(copied):
        whole_part = part.new_empty(part.numel() * mesh.size(axis))
        dist.all_gather_into_tensor(whole_part, part,
                                    group=mesh.get_group(axis))
        part = whole_part
    return part[:count].view(shape)


def reduce_to(grad, like, ranks: int, over=None, whole=None):
    """:func:`reduce_part` of ``grad`` as a DTensor placed like the
    DTensor ``like``."""
    from torch.distributed.tensor import DTensor

    part = reduce_part(grad, like.device_mesh, like.placements, ranks, over,
                       whole)
    return DTensor.from_local(part, like.device_mesh, like.placements)


def batch_ranks(mesh) -> int:
    """How many parts the batch is split into: the product of the
    data-ish axes (``data``, ``fsdp``). The ranks of the other axes
    (``tensor``, ``expert``) hold the same rows: copies."""
    sizes = mesh_shape(mesh)
    return sizes.get("data", 1) * sizes.get("fsdp", 1)


def batch_axes(mesh) -> tuple:
    """Indices of the mesh's data-ish axes (``data``, ``fsdp``)."""
    names = mesh.mesh_dim_names
    return tuple(names.index(a) for a in ("data", "fsdp") if a in names)


def mesh_all_reduce(tensor, mesh, op=None):
    """All-reduce ``tensor`` in place over every rank of ``mesh`` (SUM by
    default); a mesh of one rank leaves it as is."""
    import torch.distributed as dist

    from .mesh import axes_group

    group, members = axes_group(mesh, range(mesh.ndim))
    if len(members) > 1:
        dist.all_reduce(tensor, op=op or dist.ReduceOp.SUM, group=group)
    return tensor


def mean_metrics(metrics: dict, mesh) -> dict:
    """Step metrics averaged over the batch's parts in one all-reduce over
    the mesh; ``tokens`` (a count) is summed over the parts. Ranks that
    hold one part (a tensor or an expert group) report the same values,
    so the mean over every rank is the mean over the parts."""
    import torch

    keys = sorted(metrics)
    stacked = torch.stack([metrics[k].detach().float() for k in keys])
    mesh_all_reduce(stacked, mesh)
    ranks = mesh.mesh.numel()
    copies = ranks // batch_ranks(mesh)
    return {k: stacked[i] / copies if k == "tokens" else stacked[i] / ranks
            for i, k in enumerate(keys)}
