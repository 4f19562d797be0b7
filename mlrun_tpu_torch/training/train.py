"""Train step + trainer loop — counterpart of
``mlrun_tpu/training/train.py``.

The step runs eagerly: the model family's loss under autograd (Llama, or
MoE with ``moe_experts``), gradient accumulation, then the optax chain of
``make_optimizer`` written out (warmup-cosine schedule,
``clip_by_global_norm``, ``adamw``) updating the params in place.
``lora_rank > 0`` trains a LoRA adapter (models/lora.py) on a frozen
Llama base: gradients and AdamW touch the adapter's tensors only. The
BERT, ViT and T5 steps build on ``make_loss_step``.

With a mesh (``Trainer(mesh=)`` or ``TrainConfig.mesh_shape``; a
DeviceMesh over the process group, one rank per GPU) the state lives as
DTensors placed by the reference's rule table (parallel/sharding.py),
and each rank steps on its slice of the batch (over ``data`` x
``fsdp``). A Llama step keeps the layers sharded: each layer's ``fsdp``
shards are gathered inside the layer loop and dropped after it (again
in the backward), and each layer's gradient is reduce-scattered as soon
as it is complete (parallel/tensor.py), so a rank holds its shards of
the params, gradients and moments plus one gathered layer. On a
``tensor`` axis the layers are tensor-parallel: a rank computes its own
heads and MLP slice, the row-parallel partials all-reduced. The
embedding, the final norm and the head are gathered whole (over
``tensor`` too) inside the step, a departure from the reference, whose
XLA program keeps them sharded; they hold about 13% of Llama-3-8B's
params. The gradient norm of the clip sums every shard once. LoRA
on a ``tensor`` axis cuts the adapter to each half (parallel/tensor.py).
An MoE step places its leaves by ``make_moe_rules`` and keeps each
rank's experts local on an ``expert`` axis (models/moe.py
``ExpertParallel``); its other leaves, and every leaf of the BERT, ViT
and T5 steps (``make_loss_step``), are gathered for the step and each
gradient reduced once. The batch splits over ``data`` x ``fsdp``; the
ranks of any other axis hold the same rows. A mesh is taken even at
size 1. ``context_parallel`` ("ring" or "ulysses") shards the sequence
over a ``seq`` axis instead (models/llama_cp.py); ``pipeline_stages``
runs GPipe stages over a ``pipe`` axis (parallel/pipeline.py).

``Trainer.fit`` drives the structured callbacks of
``frameworks/_common/callbacks.py``, resumes from the environment's
checkpoint directive, attributes its wall time in a ``GoodputLedger``
(obs/goodput.py), and with ``elastic_guard`` (training/elastic.py)
reshards onto the surviving slices and back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import TRAINING_DEFAULTS
from ..execution import logging_worker
from ..models import llama as llama_mod
from ..models import moe as moe_mod
from ..models.llama import LlamaConfig
from ..models.moe import MoEConfig
from ..ops import adamw as fused_adamw
from ..parallel.mesh import make_mesh, mesh_shape
from ..parallel.sharding import (
    _map_with_path,
    batch_axes,
    batch_ranks,
    batch_sharding,
    gather,
    local_part,
    mean_metrics,
    mesh_all_reduce,
    reduce_to,
    shard_pytree,
)
from ..utils import logger
from ..utils import profiler as profiler_mod
from .data import DevicePrefetchIterator, to_device
from .mfu import ThroughputTracker, mfu
from .preemption import all_ranks_agree


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 2e-4
    warmup_steps: int = 10
    total_steps: int = 100
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    grad_accum: int = 1
    b1: float = 0.9
    b2: float = 0.95
    lora_rank: int = 0          # 0 = full fine-tune; >0 = LoRA
    lora_alpha: float = 32.0
    mesh_shape: dict | None = None
    seq_axis: str | None = None
    # chunked cross-entropy: avoids the [B,S,vocab] logits allocation
    # (0 = full logits). 512 is a good default for 128k vocab.
    loss_chunk: int = 512
    context_parallel: str | None = None
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # attention for the train step (None = keep the model config's own
    # setting): auto | flash | mlt_flash (the port's flash kernels) |
    # reference (plain softmax attention)
    attention_impl: str | None = None


def _check_options(model_config, train_config: TrainConfig,
                   shape: dict | None = None):
    """Raise the reference's ``ValueError``s: MoE with LoRA or context
    parallelism, then the context-parallel mesh validations, in its
    order. ``shape`` is the mesh's {axis: size} (default: the config's
    ``mesh_shape``)."""
    tc = train_config
    is_moe = isinstance(model_config, MoEConfig)
    if is_moe:
        if tc.lora_rank > 0:
            raise ValueError("moe_experts does not compose with lora_rank "
                             "yet")
        if tc.context_parallel:
            raise ValueError(
                "moe_experts does not compose with context_parallel yet")
    if tc.pipeline_stages > 1:
        return   # the pipeline's own checks run with its mesh
    sizes = {axis: int(n) for axis, n in (
        shape if shape is not None else tc.mesh_shape or {}).items()}
    if tc.context_parallel:
        seq_axis = tc.seq_axis or "seq"
        if seq_axis not in sizes:
            raise ValueError(
                f"context_parallel needs a '{seq_axis}' axis in the mesh")
        offending = [a for a, n in sizes.items()
                     if a not in (seq_axis, "data") and n > 1]
        if offending:
            raise ValueError(
                f"context_parallel training supports seq-only or "
                f"data x seq meshes (active axes {offending} cannot "
                f"combine with '{seq_axis}')")


def resolve_model_config(model_config: LlamaConfig,
                         train_config: TrainConfig) -> LlamaConfig:
    """Apply TrainConfig model-shaping options: ``moe_experts`` turns a
    dense LlamaConfig into an MoEConfig with the same backbone;
    ``attention_impl`` overrides the model's attention dispatch for the
    whole step."""
    if train_config.moe_experts and not isinstance(model_config, MoEConfig):
        backbone = {f.name: getattr(model_config, f.name)
                    for f in dataclasses.fields(model_config)}
        model_config = MoEConfig(
            **backbone, n_experts=train_config.moe_experts,
            top_k=train_config.moe_top_k,
            capacity_factor=train_config.moe_capacity_factor)
    _check_options(model_config, train_config)
    if train_config.attention_impl is not None:
        model_config = dataclasses.replace(
            model_config, attention_impl=train_config.attention_impl)
    return model_config


def _model_api(model_config) -> tuple[Callable, Callable]:
    """(loss, init_params) of the config's model family: one switch, so the
    dense and MoE paths share the whole trainer below it. ``loss(config,
    params, tokens, targets, loss_chunk=, lora=)`` for both."""
    if isinstance(model_config, MoEConfig):
        def moe_loss(config, params, tokens, targets, loss_chunk=0,
                     lora=None, expert_parallel=None):
            # LoRA with MoE is refused up front (_check_options)
            return moe_mod.loss_fn(config, params, tokens, targets,
                                   loss_chunk=loss_chunk,
                                   expert_parallel=expert_parallel)

        return moe_loss, moe_mod.init_params
    return llama_mod.loss_fn, llama_mod.init_params


def _family_rules(model_config, rules=None):
    """The sharding rules of the config's family unless ``rules`` are
    given: ``make_moe_rules()`` for MoE (the experts on ``expert``), the
    reference's table (None) otherwise."""
    if rules is None and isinstance(model_config, MoEConfig):
        return moe_mod.make_moe_rules()
    return rules


# -- parameter trees ----------------------------------------------------------

def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (jax.tree's order)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    return fn(tree)


def _local(leaf) -> torch.Tensor:
    """A DTensor's local shard (the same storage), a plain tensor as
    is."""
    from torch.distributed.tensor import DTensor

    return leaf.to_local() if isinstance(leaf, DTensor) else leaf


def _norm_terms(leaves) -> tuple[list, object]:
    """(the tensors whose squares the global norm adds, the mesh whose
    ranks' sums it all-reduces, or None). DTensor leaves (a sharded
    step's gradients) give their local shards, each counted on one rank
    only (coordinate 0 along every mesh axis that replicates it): a norm
    of the rank's shards alone would clip each rank differently."""
    from torch.distributed.tensor import DTensor, Replicate

    if not leaves or not isinstance(leaves[0], DTensor):
        return list(leaves), None
    mesh = leaves[0].device_mesh
    coordinate = mesh.get_coordinate()
    return [g.to_local() for g in leaves
            if all(c == 0 for c, p in zip(coordinate, g.placements)
                   if isinstance(p, Replicate))], mesh


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (optax's
    ``global_norm``); a sharded step's DTensor leaves add their counted
    local shards (``_norm_terms``), all-reduced once."""
    terms, mesh = _norm_terms(leaves)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(g.float() * g.float())
                              for g in terms))
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].to_local().device)
    for g in terms:
        local = g.float()
        total = total + torch.sum(local * local)
    mesh_all_reduce(total, mesh)
    return torch.sqrt(total)


def _clip_scale(g_norm: torch.Tensor, max_norm: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(divisor, factor) of ``clip_by_global_norm``: (g_norm, max_norm)
    where ``g_norm >= max_norm``, else (1, 1); on the device, no sync."""
    clip = g_norm >= max_norm
    one = torch.ones_like(g_norm)
    return (torch.where(clip, g_norm, one),
            torch.where(clip, torch.full_like(g_norm, max_norm), one))


# -- optimizer ----------------------------------------------------------------

def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int,
                                 decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule with end_value 0: a linear ramp
    from ``init_value`` to ``peak_value`` over ``warmup_steps``, then a
    cosine decay to 0 at ``decay_steps`` (which includes the warmup)."""

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        steps = decay_steps - warmup_steps
        t = min(count - warmup_steps, steps)
        return peak_value * 0.5 * (1.0 + math.cos(math.pi * t / steps))

    return schedule


@dataclasses.dataclass
class AdamWState:
    """optax's adamw state: the update count and the two moments, each a
    tree like the params in the params' dtype."""
    count: int
    mu: dict
    nu: dict


class AdamW:
    """The optax chain of the reference's ``make_optimizer`` written out:
    ``clip_by_global_norm(grad_clip)`` (when set), then ``adamw(schedule,
    b1, b2, eps=1e-8, weight_decay)``, applied to the params in place.

    Where optax is easy to mistake for PyTorch's own pieces:
    - the learning rate of an update is the schedule at the count BEFORE
      the increment (step 0's warmup lr is 0);
    - clipping scales by ``max_norm / g_norm`` with no epsilon, and only
      when ``g_norm >= max_norm`` (``clip_grad_norm_`` adds 1e-6);
    - the update is ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, decay
      on every leaf, with the moments rounded to their stored dtype before
      the bias correction, as optax keeps them in the params' dtype.
    All arithmetic is float32 whatever the storage dtype; nothing syncs
    the host (the clip decision stays on the device).

    CUDA leaves take the fused kernels of ``ops/adamw.py``
    (``csrc/adamw.cu``): one pass for the norm and the clip's scale, one
    for the update, with the plain loop's float32 arithmetic in its order
    and roundings; a leaf they do not take raises. CPU leaves take the
    plain loop (``_apply_plain``)."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float = 0.0):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)  # noqa: E731
        return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads: list, state: AdamWState, params) -> torch.Tensor:
        """Apply one update to ``params`` (in place) and ``state``; grads
        are in ``tree_leaves(params)`` order. Returns the global norm of
        ``grads`` before clipping. DTensor leaves update their local
        shards. Runs as the ``train.optimizer`` phase
        (``utils.profiler.phase``); on the fused route the phase's span
        carries ``fused_leaves`` and ``fused_elements`` (the local
        elements the kernels updated)."""
        with profiler_mod.phase("train.optimizer") as span:
            leaves = tree_leaves(params)
            hyper = self._constants(state.count)
            moments = (tree_leaves(state.mu), tree_leaves(state.nu))
            if leaves and _local(leaves[0]).device.type == "cuda":
                g_norm, elements = self._update_fused(grads, leaves,
                                                      *moments, *hyper)
                if span is not None:
                    span.attrs.update(fused_leaves=len(leaves),
                                      fused_elements=elements)
            else:
                g_norm = global_norm(grads)
                self._apply_plain(
                    grads, leaves, *moments, *hyper,
                    _clip_scale(g_norm, self.grad_clip)
                    if self.grad_clip else None)
            state.count += 1
            return g_norm

    def _constants(self, count: int) -> tuple[float, float, float]:
        """(lr, bc1, bc2) of the update at ``count`` (before its
        increment), each a float32 value."""
        lr = float(np.float32(self.schedule(count)))
        bc1 = float(np.float32(1.0 - self.b1 ** (count + 1)))
        bc2 = float(np.float32(1.0 - self.b2 ** (count + 1)))
        return lr, bc1, bc2

    def _apply_plain(self, grads: list, leaves: list, mus: list, nus: list,
                     lr: float, bc1: float, bc2: float, scale=None):
        """The plain loop: each leaf's update from PyTorch ops; ``scale``
        is the clip's (divisor, factor), or None for no clip."""
        for p, g, mu, nu in zip(leaves, grads, mus, nus):
            p, g, mu, nu = _local(p), _local(g), _local(mu), _local(nu)
            g32 = g.float()
            if scale is not None:
                g32 = g32 / scale[0] * scale[1]
            mu.copy_(g32 * (1.0 - self.b1) + mu.float() * self.b1)
            nu.copy_(g32 * g32 * (1.0 - self.b2) + nu.float() * self.b2)
            update = (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2)
                                           + self.eps)
            if self.weight_decay:
                update = update + p.float() * self.weight_decay
            p.copy_(p.float() + update * -lr)

    def _update_fused(self, grads: list, leaves: list, mus: list, nus: list,
                      lr: float, bc1: float, bc2: float
                      ) -> tuple[torch.Tensor, int]:
        """(g_norm, local elements updated) of the kernel route."""
        local = [[_local(t) for t in group]
                 for group in (leaves, grads, mus, nus)]
        fused_adamw.check_leaves(*local)
        terms, mesh = _norm_terms(grads)
        if mesh is None:
            out = fused_adamw.grad_sqnorm(local[1], self.grad_clip)
            g_norm, scale = out[1], out[2:]
        else:
            # a rank that counts no shard adds 0
            total = (fused_adamw.grad_sqnorm(terms, finish=False)[:1]
                     if terms else torch.zeros(1, dtype=torch.float32,
                                               device=local[1][0].device))
            mesh_all_reduce(total, mesh)
            g_norm = torch.sqrt(total[0])
            scale = torch.stack(_clip_scale(g_norm, self.grad_clip))
        fused_adamw.adamw(*local, lr=lr, b1=self.b1, b2=self.b2,
                          eps=self.eps, weight_decay=self.weight_decay,
                          bc1=bc1, bc2=bc2,
                          scale=scale if self.grad_clip else None)
        return g_norm, sum(p.numel() for p in local[0])


def make_optimizer(config: TrainConfig) -> AdamW:
    schedule = warmup_cosine_decay_schedule(
        0.0, config.learning_rate, config.warmup_steps,
        max(config.total_steps, config.warmup_steps + 1))
    return AdamW(schedule, b1=config.b1, b2=config.b2,
                 weight_decay=config.weight_decay,
                 grad_clip=config.grad_clip)


# -- step ---------------------------------------------------------------------

class TrainState:
    """Train state: the params, the optimizer state, the host step count
    and, when training LoRA, the adapter ``lora``. The trained tree (the
    params, or the adapter on a frozen base) holds leaf tensors that
    require grad; the optimizer state mirrors it."""

    def __init__(self, params, opt_state: AdamWState, step: int,
                 lora=None):
        self.params = params
        self.opt_state = opt_state
        self.step = int(step)
        self.lora = lora

    @property
    def trained(self):
        """The tree the gradients and the optimizer update."""
        return self.params if self.lora is None else self.lora


def accumulate_grads(compute_grads: Callable, tokens, targets, accum: int):
    """Gradient accumulation: split the batch into ``accum``
    micro-batches, sum ``compute_grads(tokens, targets) -> (grads,
    metrics)`` over them, average, and report the last micro-batch's
    metrics."""
    b = tokens.shape[0]
    if b < accum or b % accum:
        raise ValueError(
            f"grad_accum={accum} needs a batch divisible by it "
            f"(got batch={b}); a non-multiple would silently drop samples "
            "and an empty micro-batch yields NaN loss")
    micro = b // accum
    grads_sum, metrics = None, None
    for i in range(accum):
        part = slice(i * micro, (i + 1) * micro)
        grads, metrics = compute_grads(tokens[part], targets[part])
        grads_sum = grads if grads_sum is None else [
            a + g for a, g in zip(grads_sum, grads)]
    return [g / accum for g in grads_sum], metrics


def _gathered(tree, requires_grad: bool):
    """Plain full tensors of a DTensor tree (all-gathers where sharded),
    detached; ``requires_grad`` marks the tree the step differentiates."""
    return tree_map(lambda t: gather(t).detach().requires_grad_(
        requires_grad), tree)


def _on_mesh(compute: Callable, mesh) -> Callable:
    """Lift ``compute(params, lora, *batch) -> (grads, metrics)`` over
    plain tensors onto the mesh's DTensor state: the trees are gathered,
    every batch tensor cut to the rank's slice (dim 0 over the data-ish
    axes), and the gradients reduced to the trained tree's placements as
    the mean over the batch's parts (summed over ``data`` x ``fsdp``; the
    ranks of the other axes hold copies), the metrics averaged the same
    way."""
    ranks = batch_ranks(mesh)
    over = batch_axes(mesh)
    data = batch_sharding(mesh)

    def sharded(params, lora, *batch):
        trained = params if lora is None else lora
        full = _gathered(params, lora is None)
        full_lora = None if lora is None else _gathered(lora, True)
        grads, metrics = compute(full, full_lora,
                                 *(local_part(x, mesh, data) for x in batch))
        grads = [reduce_to(g, like, ranks, over=over)
                 for g, like in zip(grads, tree_leaves(trained))]
        return grads, mean_metrics(metrics, mesh)

    return sharded


def _layered_on_mesh(model_config, train_config: TrainConfig, mesh,
                     family_loss: Callable) -> tuple[Callable, Callable]:
    """The Llama step on a mesh: (one batch, the step's batch with
    gradient accumulation), each ``(params, lora, tokens, targets) ->
    (grads, metrics)`` over the state's DTensor trees and the global
    batch. The layers run on the rank's local shards through a
    ``parallel.tensor.LayerParallel`` (per-layer ``fsdp`` gathers, the
    tensor axis' halves); the embedding, final norm and head are gathered
    whole; every gradient comes back reduced to its leaf's placements as
    the mean over the batch's parts."""
    from torch.distributed.tensor import Shard

    from ..parallel.tensor import LayerParallel, LeafComm, check_divisible
    from ..parallel.tensor import gathered as gathered_leaf

    check_divisible(model_config, mesh_shape(mesh).get("tensor", 1))
    ranks = batch_ranks(mesh)
    batch = batch_axes(mesh)

    def local(tree, requires_grad: bool):
        return tree_map(lambda t: _local(t).detach().requires_grad_(
            requires_grad), tree)

    def outer(leaf, local_leaf):
        comm = LeafComm(mesh, leaf.placements,
                        [a for a, p in enumerate(leaf.placements)
                         if isinstance(p, Shard)],
                        batch, range(mesh.ndim), ranks)
        return gathered_leaf(local_leaf, comm)

    def local_grads(params, lora, tokens, targets):
        """Gradients of the rank's local leaves (already reduced) and the
        mean metrics, on the rank's part of the batch."""
        layer_parallel = LayerParallel(mesh, params["layers"], lora, ranks)
        shards = local(params, lora is None)
        lora_shards = None if lora is None else local(lora, True)
        view = {key: value if key == "layers" else outer(params[key], value)
                for key, value in shards.items()}
        with profiler_mod.phase("train.forward"):
            loss, metrics = family_loss(
                model_config, view, tokens, targets,
                loss_chunk=train_config.loss_chunk, lora=lora_shards,
                layer_parallel=layer_parallel)
        with profiler_mod.phase("train.backward"):
            grads = torch.autograd.grad(loss, tree_leaves(
                shards if lora is None else lora_shards))
        return list(grads), mean_metrics(
            {k: v.detach() for k, v in metrics.items()}, mesh)

    return _local_step_pair(mesh, train_config, local_grads)


def _moe_on_mesh(model_config, train_config: TrainConfig, mesh,
                 family_loss: Callable) -> tuple[Callable, Callable]:
    """The MoE step on a mesh, as :func:`_layered_on_mesh`'s pair. On an
    ``expert`` axis a rank keeps its ``n_experts / n`` experts: the
    expert leaves are gathered over every other axis, each rank's
    gradient of them is its own experts' (reduced over the batch's parts
    only); every other leaf is gathered whole (its expert ranks' copies
    cut, never summed). The rank's rows run through the layers with a
    ``models.moe.ExpertParallel`` (the group sums its ranks' partial
    outputs; the aux loss takes the global token fractions)."""
    from torch.distributed.tensor import Shard

    from ..parallel.tensor import LeafComm
    from ..parallel.tensor import gathered as gathered_leaf

    ranks = batch_ranks(mesh)
    batch = batch_axes(mesh)
    names = mesh.mesh_dim_names
    expert = names.index("expert") if "expert" in names else None
    every = tuple(range(mesh.ndim))

    def comm(path, leaf):
        placements = leaf.placements
        sharded = [a for a, p in enumerate(placements)
                   if isinstance(p, Shard)]
        if path.rsplit("/", 1)[-1] not in moe_mod.EXPERT_LEAVES                 or expert is None:
            return LeafComm(mesh, placements, sharded, batch, every, ranks)
        if isinstance(placements[expert], Shard):
            # the rank's experts stay local: its gradient is its part
            # along the expert axis
            return LeafComm(mesh, placements,
                            [a for a in sharded if a != expert], batch,
                            [a for a in every if a != expert], ranks)
        # experts replicated on the axis (other rules): each rank cuts its
        # own, so the zero-padded gradients are summed over the axis too
        return LeafComm(mesh, placements, sharded, batch + (expert,), every,
                        ranks)

    def local_grads(params, lora, tokens, targets):
        shards = {}

        def view_of(path, leaf):
            shards[path] = _local(leaf).detach().requires_grad_(True)
            return gathered_leaf(shards[path], comm(path, leaf))

        view = _map_with_path(view_of, params)
        paths = tree_leaves(_map_with_path(lambda path, _: path, params))
        with profiler_mod.phase("train.forward"):
            loss, metrics = family_loss(
                model_config, view, tokens, targets,
                loss_chunk=train_config.loss_chunk,
                expert_parallel=moe_mod.ExpertParallel(model_config, mesh))
        with profiler_mod.phase("train.backward"):
            grads = torch.autograd.grad(loss, [shards[p] for p in paths])
        return list(grads), mean_metrics(
            {k: v.detach() for k, v in metrics.items()}, mesh)

    return _local_step_pair(mesh, train_config, local_grads)


def _local_step_pair(mesh, train_config: TrainConfig,
                     local_grads: Callable) -> tuple[Callable, Callable]:
    """(one batch, the step's batch with gradient accumulation), each
    ``(params, lora, tokens, targets) -> (grads, metrics)`` over the
    state's DTensor trees and the global batch, from ``local_grads``
    (the same over the rank's rows, returning the rank's parts of the
    reduced gradients)."""
    from torch.distributed.tensor import DTensor

    data = batch_sharding(mesh)
    accum = max(1, train_config.grad_accum)

    def wrapped(batch_grads):
        def sharded(params, lora, tokens, targets):
            trained = params if lora is None else lora
            grads, metrics = batch_grads(
                params, lora, local_part(tokens, mesh, data, accum),
                local_part(targets, mesh, data, accum))
            return [DTensor.from_local(g, like.device_mesh, like.placements)
                    for g, like in zip(grads, tree_leaves(trained))], metrics

        return sharded

    def accumulated(params, lora, tokens, targets):
        if accum > 1:
            return accumulate_grads(
                lambda t, g: local_grads(params, lora, t, g), tokens,
                targets, accum)
        return local_grads(params, lora, tokens, targets)

    return wrapped(local_grads), wrapped(accumulated)


def _pp_check(train_config: TrainConfig, mesh, rules=None):
    """The reference's refusals of the pipeline trainer (``_pp_setup``),
    in its order and with its messages."""
    if rules is not None:
        raise ValueError(
            "pipeline_stages uses its own stage sharding (PP_RULES); "
            "custom sharding rules are not supported with the pipeline "
            "trainer")
    stages = train_config.pipeline_stages
    shape = {} if mesh is None else mesh_shape(mesh)
    if shape.get("pipe") != stages:
        raise ValueError(
            f"pipeline_stages={stages} needs a 'pipe' mesh axis of that "
            f"size (mesh: {shape})")
    if train_config.lora_rank:
        raise ValueError(
            "pipeline_stages does not compose with lora_rank yet")
    if train_config.context_parallel or train_config.moe_experts:
        raise ValueError(
            "pipeline_stages composes with data parallelism only (not "
            "context_parallel/moe_experts)")
    offending = [a for a, n in shape.items()
                 if a not in ("pipe", "data") and n > 1]
    if offending:
        raise ValueError(
            f"pipeline training runs on pipe (+ optional data) mesh axes; "
            f"active axes {offending} are not supported inside the "
            "pipelined region")


def _make_pp_step(model_config, train_config: TrainConfig, optimizer,
                  mesh) -> Callable:
    """The GPipe step (parallel/pipeline.py) over the mesh's ``pipe``
    axis, composing with a ``data`` axis (one pipeline per data
    coordinate) and with ``grad_accum``. A stage's layer gradients are
    averaged over ``data``; the embedding's, final norm's and head's
    are summed over the stages (the embedding on stage 0, its tied use
    as the head on the last) and averaged over ``data``. The metrics
    (the loss and accuracy of the whole batch, as the reference's
    ``pipeline_loss_fn``) reach every rank."""
    from torch.distributed.tensor import DTensor

    from ..parallel.pipeline import RankLink, Stage, run_rank

    names = mesh.mesh_dim_names
    pipe = names.index("pipe")
    stages = train_config.pipeline_stages
    microbatches = train_config.pipeline_microbatches or stages
    accum = max(1, train_config.grad_accum)
    ranks = batch_ranks(mesh)
    data_axes = tuple(names.index(a) for a in ("data",) if a in names)
    data = batch_sharding(mesh)

    def link():
        coordinate = list(mesh.get_coordinate())
        line = []
        for p in range(stages):
            coordinate[pipe] = p
            line.append(int(mesh.mesh[tuple(coordinate)]))
        return RankLink(line)

    def local_grads(params, tokens, targets):
        shards = tree_map(lambda t: _local(t).detach().requires_grad_(True),
                          params)
        view = dict(shards)
        view["layers"] = {k: v[0] for k, v in shards["layers"].items()}
        stage = Stage(model_config, view, tokens, targets,
                      mesh.get_coordinate()[pipe], stages, microbatches,
                      link(), train_config.loss_chunk)
        run_rank(stage, microbatches)
        grads = []
        paths = tree_leaves(_map_with_path(lambda path, _: path, params))
        for path, leaf, like in zip(paths, tree_leaves(shards),
                                    tree_leaves(params)):
            grad = leaf.grad if leaf.grad is not None else \
                torch.zeros_like(leaf)
            if path.startswith("layers/"):
                grads.append(reduce_to(grad, like, ranks, over=data_axes,
                                       whole=data_axes).to_local())
            else:
                grads.append(reduce_to(grad, like, ranks).to_local())
        sums = mesh_all_reduce(stage.sums(), mesh)
        count = torch.clamp_min(sums[2], 1.0)
        return grads, {"loss": sums[0] / count, "accuracy": sums[1] / count}

    def sharded(params, tokens, targets, batch_grads):
        grads, metrics = batch_grads(
            params, local_part(tokens, mesh, data, accum),
            local_part(targets, mesh, data, accum))
        return [DTensor.from_local(g, like.device_mesh, like.placements)
                for g, like in zip(grads, tree_leaves(params))], metrics

    def accumulated(params, tokens, targets):
        if accum > 1:
            return accumulate_grads(
                lambda t, g: local_grads(params, t, g), tokens, targets,
                accum)
        return local_grads(params, tokens, targets)

    def step_fn(state: TrainState, tokens, targets):
        grads, metrics = sharded(state.params, tokens, targets, accumulated)
        metrics = dict(metrics)
        metrics["grad_norm"] = optimizer.update(grads, state.opt_state,
                                                state.params)
        state.step += 1
        return state, metrics

    step_fn.compute_grads = lambda params, tokens, targets, lora=None: \
        sharded(params, tokens, targets, local_grads)
    return step_fn


def make_train_step(model_config: LlamaConfig, train_config: TrainConfig,
                    optimizer: AdamW, mesh=None, rules=None) -> Callable:
    """The step: (state, tokens, targets) -> (state, metrics), with the
    state's trained tree (the params, or the LoRA adapter) and moments
    updated in place. ``metrics`` holds the loss function's (loss,
    accuracy, tokens) and ``grad_norm`` (before clipping), all as device
    scalars. On a ``mesh`` the state is sharded (module docstring) and
    ``tokens``/``targets`` are the global batch (plain or DTensors);
    ``context_parallel`` takes models/llama_cp.py's step,
    ``pipeline_stages`` the GPipe step (``rules`` is refused there, as
    the reference refuses it). ``step_fn.compute_grads(params, tokens,
    targets, lora=None)`` gives one batch's (grads, metrics) without
    updating."""
    model_config = resolve_model_config(model_config, train_config)
    if train_config.pipeline_stages > 1:
        _pp_check(train_config, mesh, rules)
        return _make_pp_step(model_config, train_config, optimizer, mesh)
    if mesh is not None:
        _check_options(model_config, train_config, mesh_shape(mesh))
        if train_config.context_parallel:
            return _make_cp_step(model_config, train_config, optimizer,
                                 mesh)
    accum = max(1, train_config.grad_accum)
    family_loss, _ = _model_api(model_config)

    def compute_grads(params, lora, tokens, targets):
        """Gradients of the loss with respect to ``lora``'s leaves when an
        adapter is given (the base is frozen), else ``params``' leaves."""
        leaves = tree_leaves(params if lora is None else lora)
        with profiler_mod.phase("train.forward"):
            loss, metrics = family_loss(
                model_config, params, tokens, targets,
                loss_chunk=train_config.loss_chunk, lora=lora)
        with profiler_mod.phase("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def batch_grads(params, lora, tokens, targets):
        if accum > 1:
            return accumulate_grads(
                lambda t, g: compute_grads(params, lora, t, g),
                tokens, targets, accum)
        return compute_grads(params, lora, tokens, targets)

    one_batch, step_grads = compute_grads, batch_grads
    if mesh is not None and isinstance(model_config, MoEConfig):
        one_batch, step_grads = _moe_on_mesh(model_config, train_config,
                                             mesh, family_loss)
    elif mesh is not None:
        one_batch, step_grads = _layered_on_mesh(
            model_config, train_config, mesh, family_loss)

    def step_fn(state: TrainState, tokens, targets):
        grads, metrics = step_grads(state.params, state.lora, tokens,
                                    targets)
        metrics = dict(metrics)
        metrics["grad_norm"] = optimizer.update(grads, state.opt_state,
                                                state.trained)
        state.step += 1
        return state, metrics

    step_fn.compute_grads = lambda params, tokens, targets, lora=None: \
        one_batch(params, lora, tokens, targets)
    return step_fn


def _make_cp_step(model_config, train_config: TrainConfig, optimizer,
                  mesh) -> Callable:
    """The context-parallel step (models/llama_cp.py's) in the (state,
    tokens, targets) -> (state, metrics) contract; full fine-tune or
    LoRA, with gradient accumulation. The params stay replicated."""
    from ..models.llama_cp import make_cp_train_step

    raw_step = make_cp_train_step(
        model_config, mesh, optimizer,
        seq_axis=train_config.seq_axis or "seq",
        attn_impl=train_config.context_parallel,
        lora_rank=train_config.lora_rank,
        lora_alpha=train_config.lora_alpha,
        grad_accum=train_config.grad_accum)

    def step_fn(state: TrainState, tokens, targets):
        _, _, _, metrics = raw_step(state.params, state.lora,
                                    state.opt_state, tokens, targets)
        state.step += 1
        return state, metrics

    step_fn.compute_grads = raw_step.compute_grads
    return step_fn


def make_loss_step(loss: Callable, optimizer: AdamW, mesh=None,
                   with_grad_norm: bool = True, rules=None) -> Callable:
    """The train step of the BERT, ViT and T5 families:
    ``step(params, opt_state, *batch) -> (params, opt_state, metrics)``.
    ``loss(params, *batch) -> (loss, metrics)`` is differentiated with
    autograd over every leaf of ``params`` (each set to require grad), and
    ``optimizer`` updates the params and ``opt_state`` in place;
    ``metrics`` gains the pre-clip ``grad_norm`` when ``with_grad_norm``.
    On a ``mesh`` the params and moments are DTensors: trees of plain
    tensors (the same on every rank) are placed first by ``rules``
    (default the reference's table; ``parallel.sharding.shard_pytree``),
    as the reference's jit places its inputs, and the placed trees are
    returned. Every batch tensor is the global batch, split over ``data``
    x ``fsdp`` on dim 0 (the other axes' ranks compute the same rows), as
    in ``make_train_step``. ``step.compute_grads(params, *batch)``
    returns (grads in ``tree_leaves`` order, metrics) without
    updating."""
    from torch.distributed.tensor import DTensor

    def compute(params, _lora, *batch):
        leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(params)]
        value, metrics = loss(params, *batch)
        grads = torch.autograd.grad(value, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    if mesh is not None:
        compute = _on_mesh(compute, mesh)

    def compute_grads(params, *batch):
        return compute(params, None, *batch)

    def placed(params, opt_state: AdamWState):
        if mesh is None or isinstance(tree_leaves(params)[0], DTensor):
            return params, opt_state
        return (shard_pytree(params, mesh, rules), AdamWState(
            opt_state.count, shard_pytree(opt_state.mu, mesh, rules),
            shard_pytree(opt_state.nu, mesh, rules)))

    def step(params, opt_state: AdamWState, *batch):
        params, opt_state = placed(params, opt_state)
        grads, metrics = compute_grads(params, *batch)
        grad_norm = optimizer.update(grads, opt_state, params)
        if with_grad_norm:
            metrics["grad_norm"] = grad_norm
        return params, opt_state, metrics

    step.compute_grads = compute_grads
    return step


def init_train_state(model_config: LlamaConfig, train_config: TrainConfig,
                     optimizer: AdamW, device, seed: int = 0,
                     params=None, lora=None, mesh=None,
                     rules=None) -> TrainState:
    """Params drawn on ``device`` from a ``torch.Generator`` seeded with
    ``seed`` (or the given ``params``, e.g. converted from the reference
    with ``models.convert.params_from_numpy``), zero moments, step 0.
    With ``lora_rank > 0`` the params are frozen and an adapter
    (``models.lora.init_lora``: A random, B zero, drawn from the same
    generator after the params, or the given ``lora``) is trained. On a
    ``mesh`` (not context-parallel) both trees become DTensors placed by
    ``rules`` (default the reference's table); the full trees must be
    the same on every rank (the same seed or the same given params); an
    MoE model's default is ``make_moe_rules()`` (its experts on the
    ``expert`` axis). With ``pipeline_stages`` the layers are split into ``[P, L/P, ...]``
    and placed by ``PP_RULES`` (a pipe rank holds its stage's layers)."""
    from ..models.lora import init_lora

    model_config = resolve_model_config(model_config, train_config)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    if params is None:
        params = _model_api(model_config)[1](model_config, generator, device)
    is_lora = train_config.lora_rank > 0
    if is_lora and lora is None:
        lora = init_lora(model_config, generator, train_config.lora_rank,
                         train_config.lora_alpha, device=device)
    if train_config.pipeline_stages > 1:
        from ..parallel.pipeline import PP_RULES, split_layers_for_stages

        _pp_check(train_config, mesh, rules)
        params = dict(params)
        params["layers"] = split_layers_for_stages(
            params["layers"], train_config.pipeline_stages)
        params = shard_pytree(params, mesh, PP_RULES)
    elif mesh is not None and not train_config.context_parallel:
        rules = _family_rules(model_config, rules)
        params = shard_pytree(params, mesh, rules)
        lora = None if lora is None else shard_pytree(lora, mesh, rules)
    else:
        for leaf in tree_leaves(params):
            leaf.requires_grad_(not is_lora)
        for leaf in tree_leaves(lora or {}):
            leaf.requires_grad_(True)
    trained = lora if is_lora else params
    return TrainState(params, optimizer.init(trained), 0, lora)


def _state_trees(state: TrainState) -> dict:
    trees = {"params": state.params, "mu": state.opt_state.mu,
             "nu": state.opt_state.nu}
    if state.lora is not None:
        trees["lora"] = state.lora
    return trees


def _state_from(trees: dict, count: int, step: int) -> TrainState:
    return TrainState(trees["params"], AdamWState(count, trees["mu"],
                                                  trees["nu"]), step,
                      trees.get("lora"))


def _state_on(state: TrainState, mesh, rules) -> TrainState:
    """A state of ``state``'s structure, shapes and dtypes with empty
    leaves placed on ``mesh`` by ``rules`` (a restore's skeleton)."""
    import torch.distributed.tensor as dtensor

    from ..parallel.sharding import _leaf_placements

    def empty(path, leaf):
        return dtensor.empty(tuple(leaf.shape), dtype=leaf.dtype,
                             device_mesh=mesh,
                             placements=_leaf_placements(path, leaf, mesh,
                                                         rules))

    trees = {key: _map_with_path(empty, tree)
             for key, tree in _state_trees(state).items()}
    return _state_from(trees, state.opt_state.count, state.step)


def _carry_state(state, old_mesh, mesh, rules):
    """The live state carried from ``old_mesh`` onto ``mesh``: every leaf
    gathered on the old mesh's ranks, broadcast from the lowest of them
    to every rank of the group, and sharded on the new mesh's ranks
    (None on the others)."""
    old_ranks = sorted(old_mesh.mesh.flatten().tolist())
    src = old_ranks[0]
    old_member = old_mesh.get_coordinate() is not None
    new_member = mesh.get_coordinate() is not None
    device = torch.device(mesh.device_type if new_member
                          else old_mesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    def carry(leaf):
        full = leaf.full_tensor() if old_member else torch.empty(
            tuple(leaf.shape), dtype=leaf.dtype, device=device)
        dist.broadcast(full, src)
        return full

    counters = torch.tensor(
        [state.opt_state.count, state.step] if old_member else [0, 0],
        device=device)
    dist.broadcast(counters, src)
    trees = {key: tree_map(carry, tree)
             for key, tree in _state_trees(state).items()}
    if not new_member:
        return None
    trees = {key: shard_pytree(tree, mesh, rules)
             for key, tree in trees.items()}
    return _state_from(trees, int(counters[0]), int(counters[1]))


# distinct on-demand-profiler tick source per trainer instance: two
# concurrent fit loops must not jointly drain one steps-bound capture
# (utils/profiler.tick counts down only the claiming source's ticks)
_TRAINER_SEQUENCE = itertools.count(1)


class Trainer:
    """High-level trainer used by the torch framework adapter and
    ``chip_smoke.py``: ``init`` -> ``warmup`` -> ``fit``. Runs on CUDA
    unless ``device="cpu"`` is passed. ``mesh`` (a ``DeviceMesh``), or
    ``train_config.mesh_shape`` / ``context_parallel`` (a mesh built over
    the process group by ``parallel.mesh.make_mesh``), takes the sharded
    path; ``rules`` replace the reference's sharding table."""

    def __init__(self, model_config: LlamaConfig,
                 train_config: TrainConfig | None = None,
                 device: torch.device | str | None = None,
                 mesh=None, rules=None):
        # root the kernel builds in the persistent cache BEFORE anything
        # can build them: a resubmitted JobSet carrying COMPILE_CACHE_ENV
        # then loads the kernel library instead of running nvcc
        # (utils/compile_cache.py); no-op when the dir is unset
        from ..utils import compile_cache

        compile_cache.configure_from_mlconf()
        self.train_config = train_config or TrainConfig()
        self.model_config = resolve_model_config(model_config,
                                                 self.train_config)
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' for the plain CPU path")
        tc = self.train_config
        if mesh is None and (tc.mesh_shape or tc.context_parallel):
            mesh = make_mesh(tc.mesh_shape, self.device)
        self.mesh = mesh
        self.rules = rules
        self.optimizer = make_optimizer(self.train_config)
        self.step_fn = make_train_step(self.model_config, self.train_config,
                                       self.optimizer, mesh=mesh, rules=rules)
        self.state: Optional[TrainState] = None
        self._metrics_history: list[dict] = []
        # warmup() product: wall seconds of the kernel build + first pass
        self.compile_seconds: Optional[float] = None
        self._compile_attributed = False
        # fit() builds a fresh ledger here; after fit it holds the final
        # attribution (``.summary()``)
        self.goodput = None
        self._profiler_source = f"trainer-{next(_TRAINER_SEQUENCE)}"
        # device memory + host RSS exposition while this trainer lives
        # (mlt_device_mem_bytes / mlt_host_rss_bytes, scrape-time)
        from ..obs import register_memory_collector

        register_memory_collector(self)

    @property
    def world_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size()

    def init(self, seed: int = 0, params=None, lora=None) -> TrainState:
        self.state = init_train_state(
            self.model_config, self.train_config, self.optimizer,
            self.device, seed=seed, params=params, lora=lora,
            mesh=self.mesh, rules=self.rules)
        return self.state

    def warmup(self, batch_size: int, seq_len: int) -> dict:
        """Build the CUDA kernels (nvcc at first use) and run one forward
        and backward on a zero batch of ``(batch_size, seq_len)`` whose
        gradients are dropped — nothing persistent changes. Its wall time
        is ``compile_seconds`` (and the ``mlt_train_compile_seconds``
        gauge), kept out of the steady-state throughput. With a kernel
        build cache (``COMPILE_CACHE_ENV``) the build lands there, so the
        NEXT process loads the library instead of running nvcc."""
        from ..obs import TRAIN_COMPILE_SECONDS
        from ..utils import compile_cache

        assert self.state is not None, "call init() first"
        cache_dir = compile_cache.configure_from_mlconf()
        started = time.perf_counter()
        if self.device.type == "cuda":
            from ..ops import _build

            _build.library()
        zeros = torch.zeros((batch_size, seq_len), dtype=torch.int32,
                            device=self.device)
        accum = max(1, self.train_config.grad_accum)
        self.step_fn.compute_grads(self.state.params,
                                   zeros[:batch_size // accum],
                                   zeros[:batch_size // accum],
                                   self.state.lora)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.compile_seconds = time.perf_counter() - started
        TRAIN_COMPILE_SECONDS.set(self.compile_seconds)
        logger.info("train step warmed up", batch=batch_size, seq=seq_len,
                    compile_s=round(self.compile_seconds, 3),
                    cache_dir=cache_dir or "(off)")
        return {"compile_seconds": self.compile_seconds,
                "cache_dir": cache_dir,
                "batch_size": batch_size, "seq_len": seq_len}

    def shard_batch(self, tokens, targets):
        """The batch on the device; on a mesh, as DTensors holding this
        rank's slice (the batch over ``data`` x ``fsdp``; with
        ``grad_accum``, its rows of each accumulation micro-batch). With
        ``context_parallel`` the global batch stays plain: the
        context-parallel loss cuts the rank's rows and sequence shard."""
        tokens, targets = to_device((tokens, targets), self.device)
        if self.mesh is None or self.train_config.context_parallel:
            return tokens, targets
        from torch.distributed.tensor import DTensor

        placements = batch_sharding(self.mesh)
        accum = max(1, self.train_config.grad_accum)
        return tuple(DTensor.from_local(
            local_part(x, self.mesh, placements, accum), self.mesh,
            placements) for x in (tokens, targets))

    def train_step(self, tokens, targets) -> dict:
        return self._dispatch(*self.shard_batch(tokens, targets))

    def _dispatch(self, tokens, targets) -> dict:
        self.state, metrics = self.step_fn(self.state, tokens, targets)
        return metrics

    def _maybe_resume(self, checkpoint_manager, context) -> bool:
        """Honour the checkpoint-resume directive of the environment
        (``MLT_RESUME_FROM_CHECKPOINT`` / ``MLT_RESUME_STEP``, written
        into a resubmitted job): restore the train state from
        ``checkpoint_manager`` before the first step. No directive or no
        manager: nothing (no device sync either). A state that already
        advanced (an explicit restore) wins. A failed restore logs a
        warning and training starts fresh. Returns whether a directive
        was honoured."""
        from ..obs import flight_record
        from .checkpoint import resume_directive

        directive = resume_directive()
        if directive is None or checkpoint_manager is None:
            return False
        if int(self.state.step) != 0:
            return True
        path, step = directive
        try:
            self.state = checkpoint_manager.restore(self.state, step=step)
        except Exception as exc:  # noqa: BLE001 - a missing or corrupt
            # checkpoint must not turn a resumable run into a crash loop
            logger.warning("checkpoint resume failed — starting fresh",
                           path=path, step=step, error=str(exc))
            return True
        logger.info("resumed from checkpoint", path=path,
                    step=int(self.state.step))
        flight_record("train.resume", path=str(path),
                      step=int(self.state.step))
        if context is not None and hasattr(context, "log_result"):
            context.log_result("resumed_from_step", int(self.state.step))
        return True

    def _rules(self):
        if self.train_config.pipeline_stages > 1:
            from ..parallel.pipeline import PP_RULES

            return PP_RULES
        return _family_rules(self.model_config, self.rules)

    def reshard(self, ranks, checkpoint_manager=None) -> dict:
        """Rebuild the mesh and the step over ``ranks`` and move the train
        state onto it — the elastic slice-loss / grow-back core. The
        mesh's shape is refit by rescaling one axis
        (``parallel.mesh.refit_shape``). Every rank of the process group
        calls it (it creates the new mesh's groups); a rank outside
        ``ranks`` keeps no state and sits out until a later reshard takes
        it back.

        With a checkpoint in ``checkpoint_manager`` the new mesh's ranks
        restore its latest step under the new placements (DCP reads it
        across world sizes): after a slice death the only honest source,
        as the dead slice's shards are gone. Without one (grow-back, where
        the survivors hold everything, or a simulated shrink that never
        checkpointed) the live state is carried over: the old mesh's ranks
        gather each leaf, the lowest of them broadcasts it to every rank,
        and the new mesh's ranks shard it (a carried shrink reads the
        failed slice's shards, possible here because no rank died). A
        rank left out keeps its stale state only as the template (shapes
        and dtypes) of what a grow sends it.
        Returns the decision record of the flight recorder's chain."""
        from ..parallel.mesh import refit_shape

        assert self.state is not None, "call init() first"
        if self.mesh is None or self.train_config.context_parallel:
            raise ValueError(
                "elastic resharding needs a trainer on a sharded mesh (the "
                "context-parallel step keeps its params replicated)")
        ranks = sorted(int(r) for r in ranks)
        old_mesh, old_world = self.mesh, self.world_size
        new_shape = refit_shape(mesh_shape(old_mesh), len(ranks))
        started = time.perf_counter()
        mesh = make_mesh(new_shape, self.device, ranks=ranks)
        step_fn = make_train_step(self.model_config, self.train_config,
                                  self.optimizer, mesh=mesh,
                                  rules=self.rules)
        latest = checkpoint_manager.latest_step() \
            if checkpoint_manager is not None else None
        member = mesh.get_coordinate() is not None
        if latest is not None:
            state = checkpoint_manager.restore(
                _state_on(self.state, mesh, self._rules()), step=latest) \
                if member else None
            decision = "restore_checkpoint"
        else:
            state = _carry_state(self.state, old_mesh, mesh, self._rules())
            decision = "carry_live_state"
        # swap only once the transfer succeeded: a failed restore leaves
        # the trainer on its old (still valid) world. A rank outside the
        # new mesh keeps its stale state as the template of what a later
        # grow sends it
        self.mesh, self.step_fn = mesh, step_fn
        if member:
            self.state = state
        info = {"world_from": old_world, "world_to": mesh.size(),
                "decision": decision,
                "restored_step": state.step if member else None,
                "reshard_s": time.perf_counter() - started}
        logger.info("resharded train state", **{
            k: round(v, 3) if isinstance(v, float) else v
            for k, v in info.items()})
        return info

    @property
    def sitting_out(self) -> bool:
        """Whether this rank is outside the trainer's mesh (its slice
        failed): it takes no step until a reshard takes it back, and its
        ``state`` is stale."""
        return self.mesh is not None and self.mesh.get_coordinate() is None

    def fit(self, data_iter, steps: int, context=None,
            log_every: int = 10, callbacks: list | None = None,
            checkpoint_manager=None, preemption_guard=None,
            elastic_guard=None, epoch_steps: int = 0,
            prefetch: int | None = None,
            defer_metrics: bool | None = None) -> dict:
        """Run the training loop; logs metrics to ``context`` (duck-typed
        ``log_metrics(metrics, step=)``) at log points. A resume directive
        in the environment restores the state from ``checkpoint_manager``
        first (:meth:`_maybe_resume`). With ``preemption_guard`` +
        ``checkpoint_manager``, a SIGTERM triggers one final synchronous
        checkpoint and an early return with ``preempted: True`` (over
        many ranks the latch is agreed every step, so every rank saves
        after the same step).

        ``prefetch`` (default ``TRAINING_DEFAULTS["prefetch"]``) wraps
        ``data_iter`` in a :class:`~.data.DevicePrefetchIterator`;
        ``defer_metrics`` (default on) stages log-point metrics as
        non-blocking copies into pinned host tensors read one log point
        later, so the host never waits on the device there. Callbacks
        force the synchronous read: structured
        ``frameworks._common.Callback`` objects (``on_train_begin``,
        ``on_step_end`` on every step with the raw device metrics off the
        log points, ``on_epoch_end`` every ``epoch_steps`` steps with host
        floats, ``on_train_end``; ``False`` from a step or epoch hook
        stops the loop with ``stopped_early: True``; over many ranks the
        vote is agreed at log points and epoch ends, so every rank stops
        in the same step) and bare ``callback(step, metrics, trainer)``
        callables, fired at log points. ``tokens_per_sec``/``mfu`` are
        steady-state (after ``warmup_steps_excluded`` steps); the first
        step's build is reported as ``compile_seconds``.

        With ``elastic_guard`` (:class:`~.elastic.ElasticGuard`) the run
        survives losing a slice: the guard is polled once per step; a
        ``fail`` event reshards onto the survivors (:meth:`reshard`,
        restoring the latest checkpoint of ``checkpoint_manager``) and
        training goes on at the smaller world size, the failed slice's
        ranks sitting out, until a ``join`` event grows it back with the
        live state. The chain ``train.slice_fail`` -> ``train.reshard``
        -> ``train.slice_join`` -> ``train.grow`` lands in the flight
        recorder, a ``slice-preemption`` dump is written on a failure,
        and each history entry carries ``world_size``.

        Every wall-second lands in ``self.goodput`` (a
        :class:`~..obs.goodput.GoodputLedger`): ``step`` is goodput; the
        build (``compile``, ``re_warm`` after a resume), ``data_wait``,
        ``h2d``, ``metric_flush``, ``checkpoint`` and ``reshard`` are
        badput; while degraded, the lost capacity's share of each step is
        ``degraded`` (all of a sitting-out rank's time);
        ``goodput_fraction`` is its fraction at the log point; the flight
        recorder gets ``train.step`` there, ``train.preempt`` before a
        preemption checkpoint and ``train.exception`` (with a
        ``train-crash`` dump) when the loop raises.

        While phase capture is on (a torch.profiler session records, or
        ``obs.get_tracer().configure(phases=True)``) each step lands in
        the process tracer as ``utils.profiler.phase`` spans sharing the
        fit's trace id (``trace_id_for`` the run uid, else a fresh one):
        ``train.data_wait``, ``train.h2d``, ``train.step`` (over the
        step's forward, backward and optimizer phases, with ``gap_ms``
        from the previous step and the allocator counters' change),
        ``train.callbacks`` and ``train.metric_flush``."""
        from ..frameworks._common.callbacks import CallbackList
        from ..obs import (
            TRAIN_COMPILE_SECONDS,
            TRAIN_H2D_BYTES,
            TRAIN_INPUT_WAIT,
            TRAIN_MFU,
            TRAIN_STEP_TIME,
            GoodputLedger,
            flight_record,
            get_flight_recorder,
            new_trace_id,
            trace_id_for,
        )
        from ..parallel.mesh import axes_group

        assert self.state is not None, "call init() first"
        run_uid = str(getattr(context, "uid", "") or "") \
            if context is not None else ""
        # the run's own writes land from the logging worker only (the
        # reference's run context gates them); callbacks and the profiler
        # still get the context on every rank
        log_ctx = context if context is not None \
            and logging_worker(context) else None
        ledger = self.goodput = GoodputLedger(run=run_uid)
        trace = trace_id_for(run_uid) if run_uid else new_trace_id()

        @contextlib.contextmanager
        def flushing():
            """A metric flush: the ledger's ``metric_flush`` bucket and
            the ``train.metric_flush`` phase."""
            with ledger.phase("metric_flush"), profiler_mod.phase(
                    "train.metric_flush", trace_id=trace,
                    step=getattr(self.state, "step", None)):
                yield

        with ledger.phase("checkpoint"):
            resumed = self._maybe_resume(checkpoint_manager, log_ctx)
        if self.compile_seconds is not None and not self._compile_attributed:
            # warmup() ran before this fit's wall window opened
            self._compile_attributed = True
            ledger.attribute("re_warm" if resumed else "compile",
                             self.compile_seconds)
        flight_record("train.fit_begin", run=run_uid, steps=steps,
                      resumed=resumed)
        hooks = CallbackList(callbacks, context=context, trainer=self)

        def agree(flag: bool) -> bool:
            """A vote agreed over the ranks stepping together (the mesh's,
            the whole group's without one)."""
            group = None if self.mesh is None else \
                axes_group(self.mesh, range(self.mesh.ndim))[0]
            return all_ranks_agree(flag, self.device, group)

        def multihost() -> bool:
            if self.mesh is not None:
                return self.world_size > 1
            return dist.is_initialized() and dist.get_world_size() > 1

        depth = (int(TRAINING_DEFAULTS["prefetch"]) if prefetch is None
                 else int(prefetch))
        prefetcher = (data_iter
                      if isinstance(data_iter, DevicePrefetchIterator)
                      else None)
        owned = None
        if depth > 0 and prefetcher is None:
            data_iter = owned = prefetcher = DevicePrefetchIterator(
                data_iter, device=self.device, depth=depth)
        defer = (bool(TRAINING_DEFAULTS["defer_metrics"])
                 if defer_metrics is None else bool(defer_metrics))
        defer = defer and not hooks.callbacks
        cuda = self.device.type == "cuda"

        tracker = ThroughputTracker(
            int(TRAINING_DEFAULTS["warmup_steps_excluded"]))
        input_wait = 0.0     # host seconds blocked in next(data_iter)
        wait_flushed = 0.0   # portion already on the registry counter
        h2d_inline = 0       # bytes placed on the no-prefetch path
        # a caller-owned prefetcher may carry bytes from an earlier fit
        h2d_flushed = (prefetcher.stats()["h2d_bytes"]
                       if prefetcher is not None and owned is None else 0)
        pending = None
        last: dict = {}

        def _flush_obs():
            nonlocal wait_flushed, h2d_flushed
            if input_wait > wait_flushed:
                TRAIN_INPUT_WAIT.inc(input_wait - wait_flushed)
                wait_flushed = input_wait
            total = (prefetcher.stats()["h2d_bytes"]
                     if prefetcher is not None else h2d_inline)
            if total > h2d_flushed:
                TRAIN_H2D_BYTES.inc(total - h2d_flushed)
                h2d_flushed = total

        def _log_view(view: dict) -> dict:
            self._metrics_history.append(view)
            if log_ctx is not None:
                log_ctx.log_metrics(view, step=view["step"])
            elif context is None:
                logger.info("train step", **{
                    k: round(v, 4) if isinstance(v, float) else v
                    for k, v in view.items()})
            return view

        def _stage(metrics: dict, extras: dict):
            """Non-blocking device->host copies into pinned tensors, read
            at the NEXT log point (or the loop exit)."""
            staged = {}
            for key, value in metrics.items():
                host = torch.empty(value.shape, dtype=value.dtype,
                                   pin_memory=cuda)
                host.copy_(value, non_blocking=cuda)
                staged[key] = host
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            return (self.state.step, staged, extras, done)

        def _drain(entry) -> dict:
            step_no, staged, extras, done = entry
            if done is not None:
                done.synchronize()
            view = {k: float(v) for k, v in staged.items()}
            view.update(extras)
            view["step"] = step_no
            return _log_view(view)

        def _extras(step_tokens: int, seq_len: int) -> dict:
            tps = tracker.tokens_per_sec()
            extras = {
                "tokens_per_sec": tps,
                "tokens_per_sec_per_chip": tps / self.world_size,
                "mfu": mfu(tps, self.model_config.flops_per_token(seq_len),
                           n_chips=self.world_size, device=self.device),
                "input_wait_seconds": input_wait,
            }
            if self.compile_seconds is not None:
                extras["compile_seconds"] = self.compile_seconds
            if elastic_guard is not None:
                extras["world_size"] = self.world_size
            extras["goodput_fraction"] = ledger.goodput_fraction()
            if tps > 0:
                TRAIN_STEP_TIME.set(step_tokens / tps, timer="fit")
            TRAIN_MFU.set(extras["mfu"])
            return extras

        # elastic degraded-capacity accounting: while the run is at W' of W
        # ranks, the (1 - W'/W) share of every step-second moves from
        # goodput into 'degraded' (transfer() only reclassifies, so the
        # attribution still sums to wall)
        degraded_lost = 0.0   # capacity fraction currently lost
        degraded_mark = 0.0   # goodput seconds already taxed
        reshard_pending = False

        def _degraded_tax():
            nonlocal degraded_mark
            good = ledger.goodput_seconds()
            if degraded_lost <= 0.0:
                degraded_mark = good
                return
            delta = good - degraded_mark
            if delta > 0:
                moved = delta * degraded_lost
                ledger.transfer("step", "degraded", moved)
                degraded_mark = good - moved

        def _elastic_event(event):
            nonlocal pending, last, reshard_pending, degraded_lost, \
                degraded_mark
            # a staged log point lands before the world changes
            if pending is not None:
                with flushing():
                    last = _drain(pending)
                pending = None
            _degraded_tax()   # settle the tax at the old rate
            step_before = None if self.state is None else self.state.step
            if event.kind == "fail":
                flight_record("train.slice_fail", run=run_uid,
                              step=step_before, slice=event.slice_index,
                              survivors=len(event.ranks),
                              survivor_ranks=list(event.ranks))
            else:
                flight_record("train.slice_join", run=run_uid,
                              step=step_before, slice=event.slice_index,
                              world=len(event.ranks))
            with ledger.phase("reshard"):
                # a shrink restores the last checkpoint (the dead slice's
                # shards are gone); a grow carries the survivors' state
                info = self.reshard(event.ranks, checkpoint_manager
                                    if event.kind == "fail" else None)
            reshard_pending = True
            degraded_lost = elastic_guard.lost_fraction()
            degraded_mark = ledger.goodput_seconds()
            flat = {k: round(v, 3) if isinstance(v, float) else v
                    for k, v in info.items()}
            if event.kind == "fail":
                get_flight_recorder().dump(
                    "slice-preemption",
                    extra={"run": run_uid, "slice": event.slice_index,
                           "survivors": list(event.ranks), **flat})
                flight_record("train.reshard", run=run_uid, **flat)
            else:
                flight_record("train.grow", run=run_uid, **flat)
            if log_ctx is not None and hasattr(log_ctx, "log_result"):
                log_ctx.log_result("world_size", info["world_to"])

        hooks.on_train_begin()
        prev_step = None   # the last step's phase, for the next one's gap
        epoch = 0
        stopped = False
        local_stop = False   # a pending stop vote, agreed at uniform points
        if epoch_steps:
            hooks.on_epoch_begin(0)
        try:
            for step in range(steps):
                if preemption_guard is not None and \
                        preemption_guard.agreed(self.device):
                    at = None if self.sitting_out else self.state.step
                    logger.warning("preempted — checkpointing before exit",
                                   step=at)
                    flight_record("train.preempt", run=run_uid, step=at)
                    if pending is not None:
                        with flushing():
                            last = _drain(pending)
                        pending = None
                    if checkpoint_manager is not None and \
                            not self.sitting_out:
                        with ledger.phase("checkpoint"):
                            checkpoint_manager.save(self.state.step,
                                                    self.state, force=True)
                            checkpoint_manager.wait()
                        if log_ctx is not None and \
                                hasattr(log_ctx, "log_checkpoint"):
                            log_ctx.log_checkpoint(
                                checkpoint_manager.directory, step=at,
                                commit=False)
                    last = dict(last)
                    last["preempted"] = True
                    last["step"] = at
                    if log_ctx is not None and hasattr(log_ctx,
                                                       "log_result"):
                        log_ctx.log_result("preempted", True)
                    # a preempted run still finalizes its callbacks (close
                    # writers, log the tensorboard dir): their artifacts
                    # are what survives the eviction
                    hooks.on_train_end(last)
                    return last
                if elastic_guard is not None:
                    event = elastic_guard.poll()
                    if event is not None:
                        _elastic_event(event)
                    if self.sitting_out:
                        # this rank's slice is out: it enters none of the
                        # survivors' collectives, and keeps its stream in
                        # step with theirs
                        ledger.enter("degraded")
                        next(data_iter)
                        continue
                n = self.state.step
                ledger.enter("data_wait")
                with profiler_mod.phase("train.data_wait", trace_id=trace,
                                        step=n):
                    t_input = time.perf_counter()
                    tokens, targets = next(data_iter)
                    input_wait += time.perf_counter() - t_input
                if prefetcher is None:
                    h2d_inline += (getattr(tokens, "nbytes", 0)
                                   + getattr(targets, "nbytes", 0))
                ledger.enter("h2d")
                with profiler_mod.phase("train.h2d", trace_id=trace, step=n):
                    tokens, targets = self.shard_batch(tokens, targets)
                seq_len = tokens.shape[1]
                ledger.enter("step")
                t_dispatch = time.perf_counter()
                with profiler_mod.phase("train.step", trace_id=trace, step=n,
                                        follows=prev_step) as step_phase:
                    counts = (profiler_mod.allocator_counts(self.device)
                              if step_phase is not None and cuda else None)
                    metrics = self._dispatch(tokens, targets)
                    if counts is not None:
                        after = profiler_mod.allocator_counts(self.device)
                        step_phase.attrs.update(
                            {k: after[k] - v for k, v in counts.items()})
                prev_step = step_phase
                if step == 0 and self.compile_seconds is None:
                    # the first step builds the kernels (nvcc) inside its
                    # first launch — build-class time, kept out of goodput
                    self.compile_seconds = time.perf_counter() - t_dispatch
                    TRAIN_COMPILE_SECONDS.set(self.compile_seconds)
                    self._compile_attributed = True
                    ledger.enter("step")
                    ledger.transfer("step", "re_warm" if resumed
                                    else "compile", self.compile_seconds)
                elif reshard_pending:
                    # the first step after a reshard forms the new mesh's
                    # communicators: reshard-class time, not goodput
                    reshard_pending = False
                    first = time.perf_counter() - t_dispatch
                    ledger.enter("step")
                    ledger.transfer("step", "reshard", first)
                    degraded_mark = ledger.goodput_seconds()
                    flight_record("train.reshard_warm", run=run_uid,
                                  loop_step=step, compile_s=round(first, 3))
                # on-demand profiling: claims or advances an armed capture;
                # one global check when dark
                profiler_mod.tick(self._profiler_source, context)
                tracker.note_step(tokens.shape[0] * seq_len)
                log_point = (step + 1) % log_every == 0 or step == steps - 1
                # non-log steps hand callbacks the raw device metrics: no
                # float() there, so the host keeps dispatching ahead of
                # the device; a callback that reads a value pays its sync
                step_metrics: dict = dict(metrics)
                if log_point:
                    _degraded_tax()
                    extras = _extras(tokens.shape[0] * seq_len, seq_len)
                    _flush_obs()
                    flight_record("train.step", run=run_uid, step=step + 1,
                                  goodput_fraction=round(
                                      extras["goodput_fraction"], 4))
                    if defer:
                        if pending is not None:
                            with flushing():
                                last = _drain(pending)
                        pending = _stage(metrics, extras)
                    else:
                        # read first (a device sync), then log: the window
                        # then holds the finished steps only
                        with flushing():
                            step_metrics = {k: float(v)
                                            for k, v in metrics.items()}
                            step_metrics.update(extras)
                            step_metrics["step"] = self.state.step
                            last = _log_view(step_metrics)
                    ledger.export()
                if not hooks.callbacks:
                    continue
                with profiler_mod.phase("train.callbacks", trace_id=trace,
                                        step=n):
                    voted = hooks.on_step_end(step, step_metrics,
                                              log_point=log_point)
                if not voted:
                    local_stop = True
                if not multihost():
                    stopped = stopped or local_stop
                elif log_point:
                    # every rank must stop in the same step: votes are
                    # agreed at log points, step indices every rank reaches
                    stopped = agree(local_stop)
                if epoch_steps and ((step + 1) % epoch_steps == 0
                                    or step == steps - 1 or stopped):
                    # epoch hooks always see host floats
                    with profiler_mod.phase("train.callbacks",
                                            trace_id=trace, step=n):
                        epoch_view = step_metrics if log_point else \
                            {k: float(v) for k, v in metrics.items()}
                        epoch_vote = not hooks.on_epoch_end(epoch,
                                                            epoch_view)
                    local_stop = local_stop or epoch_vote
                    if not multihost():
                        stopped = stopped or epoch_vote
                    elif not stopped:
                        stopped = agree(local_stop)
                    epoch += 1
                    if not stopped and step < steps - 1:
                        hooks.on_epoch_begin(epoch)
                if stopped:
                    last = dict(last) if last else \
                        {k: float(v) for k, v in metrics.items()}
                    last["stopped_early"] = True
                    last.setdefault("step", self.state.step)
                    break
            if pending is not None:
                with flushing():
                    last = _drain(pending)
                pending = None
            hooks.on_train_end(last)
            return last
        except BaseException as unwinding:
            # the event sequence into the failure is the post-mortem
            # artifact; guarded, so the original exception wins the unwind
            try:
                flight_record("train.exception", run=run_uid,
                              error=str(unwinding),
                              error_type=type(unwinding).__name__)
                get_flight_recorder().dump(
                    "train-crash", extra={"run": run_uid,
                                          "error": str(unwinding)})
            except Exception:  # noqa: BLE001
                pass
            raise
        finally:
            if pending is not None:
                # exception exit with a staged log point: land it in the
                # history/context before unwinding
                try:
                    _drain(pending)
                except Exception:  # noqa: BLE001 - the original
                    pass           # exception must win the unwind
            _flush_obs()
            _degraded_tax()
            ledger.close()
            if owned is not None:
                owned.close()

    @property
    def metrics_history(self) -> list[dict]:
        return list(self._metrics_history)
