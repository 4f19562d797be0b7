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
``data`` x ``fsdp`` DeviceMesh over the process group, one rank per GPU)
the state lives as DTensors placed by the reference's rule table
(parallel/sharding.py). A step gathers the params into plain tensors, so
the kernels never see a DTensor, runs the unchanged loss on the rank's
slice of the batch, and brings the gradients back to the params'
placements as the mean over the ranks (one reduce-scatter a leaf); the
gradient norm of the clip sums every shard once. Between steps the
params and the AdamW moments are sharded; inside a step every rank holds
the full params and their full gradients. A mesh is taken even at size
1. ``context_parallel`` ("ring" or "ulysses") shards the sequence
over a ``seq`` axis instead (models/llama_cp.py).

``Trainer.fit`` drives the structured callbacks of
``frameworks/_common/callbacks.py``, resumes from the environment's
checkpoint directive, and attributes its wall time in a
``GoodputLedger`` (obs/goodput.py). Features of the reference trainer
that the port does not have yet (tensor, pipeline and expert
parallelism, elastic training) raise ``NotImplementedError`` naming their
ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import TRAINING_DEFAULTS
from ..models import llama as llama_mod
from ..models import moe as moe_mod
from ..models.llama import LlamaConfig
from ..models.moe import MoEConfig
from ..parallel.mesh import make_mesh, mesh_shape
from ..parallel.sharding import (
    batch_sharding,
    gather,
    local_part,
    mean_metrics,
    reduce_to,
    shard_pytree,
)
from ..serving.resilience import not_ported
from ..utils import logger
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


def _check_ported(model_config, train_config: TrainConfig,
                  shape: dict | None = None):
    """Raise the reference's ``ValueError``s (MoE with LoRA or context
    parallelism, then the context-parallel mesh validations, in its
    order), then ``NotImplementedError`` for the options the port does
    not have yet. ``shape`` is the mesh's {axis: size} (default: the
    config's ``mesh_shape``)."""
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
        raise not_ported("pipeline parallelism (pipeline_stages)", 7)
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
        return
    if sizes.get("tensor", 1) > 1:
        raise not_ported("tensor parallelism (a 'tensor' mesh axis)", 7)
    others = [a for a, n in sizes.items() if a not in ("data", "fsdp")
              and n > 1]
    if others:
        raise not_ported(f"training over mesh axes {others} (the port "
                         f"trains on data x fsdp meshes)", 7)
    if is_moe and math.prod(n for n in sizes.values() if n > 0) > 1:
        raise not_ported("expert parallelism (moe_experts on a mesh over "
                         "more than one device)", 7)


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
    _check_ported(model_config, train_config)
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
                     lora=None):
            # LoRA with MoE is refused up front (_check_ported)
            return moe_mod.loss_fn(config, params, tokens, targets,
                                   loss_chunk=loss_chunk)

        return moe_loss, moe_mod.init_params
    return llama_mod.loss_fn, llama_mod.init_params


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


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (optax's
    ``global_norm``). DTensor leaves (a sharded step's gradients) add
    their local shards, each counted on one rank only (coordinate 0 along
    every mesh axis that replicates it), and the sum is all-reduced once:
    a norm of the rank's shards alone would clip each rank differently."""
    from torch.distributed.tensor import DTensor, Replicate

    if not leaves or not isinstance(leaves[0], DTensor):
        return torch.sqrt(sum(torch.sum(g.float() * g.float())
                              for g in leaves))
    coordinate = leaves[0].device_mesh.get_coordinate()
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].to_local().device)
    for g in leaves:
        if all(c == 0 for c, p in zip(coordinate, g.placements)
               if isinstance(p, Replicate)):
            local = g.to_local().float()
            total = total + torch.sum(local * local)
    dist.all_reduce(total)
    return torch.sqrt(total)


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
    the host (the clip decision stays on the device)."""

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
        shards."""
        leaves = tree_leaves(params)
        g_norm = global_norm(grads)
        if self.grad_clip:
            clip = g_norm >= self.grad_clip
            one = torch.ones_like(g_norm)
            divisor = torch.where(clip, g_norm, one)
            factor = torch.where(clip, torch.full_like(g_norm,
                                                       self.grad_clip), one)
        lr = float(np.float32(self.schedule(state.count)))
        count = state.count + 1
        bc1 = float(np.float32(1.0 - self.b1 ** count))
        bc2 = float(np.float32(1.0 - self.b2 ** count))
        for p, g, mu, nu in zip(leaves, grads, tree_leaves(state.mu),
                                tree_leaves(state.nu)):
            p, g, mu, nu = _local(p), _local(g), _local(mu), _local(nu)
            g32 = g.float()
            if self.grad_clip:
                g32 = g32 / divisor * factor
            mu.copy_(g32 * (1.0 - self.b1) + mu.float() * self.b1)
            nu.copy_(g32 * g32 * (1.0 - self.b2) + nu.float() * self.b2)
            update = (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2)
                                           + self.eps)
            if self.weight_decay:
                update = update + p.float() * self.weight_decay
            p.copy_(p.float() + update * -lr)
        state.count = count
        return g_norm


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
    the mean over the ranks, the metrics averaged the same way."""
    ranks = mesh.size()
    data = batch_sharding(mesh)

    def sharded(params, lora, *batch):
        trained = params if lora is None else lora
        full = _gathered(params, lora is None)
        full_lora = None if lora is None else _gathered(lora, True)
        grads, metrics = compute(full, full_lora,
                                 *(local_part(x, mesh, data) for x in batch))
        grads = [reduce_to(g, like, ranks)
                 for g, like in zip(grads, tree_leaves(trained))]
        return grads, mean_metrics(metrics, ranks)

    return sharded


def make_train_step(model_config: LlamaConfig, train_config: TrainConfig,
                    optimizer: AdamW, mesh=None) -> Callable:
    """The step: (state, tokens, targets) -> (state, metrics), with the
    state's trained tree (the params, or the LoRA adapter) and moments
    updated in place. ``metrics`` holds the loss function's (loss,
    accuracy, tokens) and ``grad_norm`` (before clipping), all as device
    scalars. On a ``mesh`` the state is sharded (module docstring) and
    ``tokens``/``targets`` are the global batch (plain or DTensors);
    ``context_parallel`` takes models/llama_cp.py's step.
    ``step_fn.compute_grads(params, tokens, targets, lora=None)`` gives
    one batch's (grads, metrics) without updating."""
    model_config = resolve_model_config(model_config, train_config)
    if mesh is not None:
        _check_ported(model_config, train_config, mesh_shape(mesh))
        if train_config.context_parallel:
            return _make_cp_step(model_config, train_config, optimizer,
                                 mesh)
    accum = max(1, train_config.grad_accum)
    family_loss, _ = _model_api(model_config)

    def compute_grads(params, lora, tokens, targets):
        """Gradients of the loss with respect to ``lora``'s leaves when an
        adapter is given (the base is frozen), else ``params``' leaves."""
        leaves = tree_leaves(params if lora is None else lora)
        loss, metrics = family_loss(
            model_config, params, tokens, targets,
            loss_chunk=train_config.loss_chunk, lora=lora)
        grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def batch_grads(params, lora, tokens, targets):
        if accum > 1:
            return accumulate_grads(
                lambda t, g: compute_grads(params, lora, t, g),
                tokens, targets, accum)
        return compute_grads(params, lora, tokens, targets)

    one_batch, step_grads = compute_grads, batch_grads
    if mesh is not None:
        one_batch, step_grads = (_on_mesh(compute_grads, mesh),
                                 _on_mesh(batch_grads, mesh))

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
                   with_grad_norm: bool = True) -> Callable:
    """The train step of the BERT, ViT and T5 families:
    ``step(params, opt_state, *batch) -> (params, opt_state, metrics)``.
    ``loss(params, *batch) -> (loss, metrics)`` is differentiated with
    autograd over every leaf of ``params`` (each set to require grad), and
    ``optimizer`` updates the params and ``opt_state`` in place;
    ``metrics`` gains the pre-clip ``grad_norm`` when ``with_grad_norm``.
    On a ``mesh`` the params and moments are DTensors (``parallel.
    sharding.shard_pytree``) and every batch tensor is the global batch,
    split over the data-ish axes on dim 0, as in ``make_train_step``.
    ``step.compute_grads(params, *batch)`` returns (grads in
    ``tree_leaves`` order, metrics) without updating."""

    def compute(params, _lora, *batch):
        leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(params)]
        value, metrics = loss(params, *batch)
        grads = torch.autograd.grad(value, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    if mesh is not None:
        compute = _on_mesh(compute, mesh)

    def compute_grads(params, *batch):
        return compute(params, None, *batch)

    def step(params, opt_state: AdamWState, *batch):
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
    the same on every rank (the same seed or the same given params)."""
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
    if mesh is not None and not train_config.context_parallel:
        params = shard_pytree(params, mesh, rules)
        lora = None if lora is None else shard_pytree(lora, mesh, rules)
    else:
        for leaf in tree_leaves(params):
            leaf.requires_grad_(not is_lora)
        for leaf in tree_leaves(lora or {}):
            leaf.requires_grad_(True)
    trained = lora if is_lora else params
    return TrainState(params, optimizer.init(trained), 0, lora)


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
                                       self.optimizer, mesh=mesh)
        self.state: Optional[TrainState] = None
        self._metrics_history: list[dict] = []
        # warmup() product: wall seconds of the kernel build + first pass
        self.compile_seconds: Optional[float] = None
        self._compile_attributed = False
        # fit() builds a fresh ledger here; after fit it holds the final
        # attribution (``.summary()``)
        self.goodput = None

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
        gauge), kept out of the steady-state throughput."""
        from ..obs import TRAIN_COMPILE_SECONDS

        assert self.state is not None, "call init() first"
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
                    compile_s=round(self.compile_seconds, 3))
        return {"compile_seconds": self.compile_seconds,
                "batch_size": batch_size, "seq_len": seq_len}

    def shard_batch(self, tokens, targets):
        """The batch on the device; on a mesh, as DTensors holding this
        rank's slice (the batch over ``data`` x ``fsdp``). With
        ``context_parallel`` the global batch stays plain: the
        context-parallel loss cuts the rank's rows and sequence shard."""
        tokens, targets = to_device((tokens, targets), self.device)
        if self.mesh is None or self.train_config.context_parallel:
            return tokens, targets
        from torch.distributed.tensor import DTensor

        placements = batch_sharding(self.mesh)
        return tuple(DTensor.from_local(local_part(x, self.mesh, placements),
                                        self.mesh, placements)
                     for x in (tokens, targets))

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

        Every wall-second lands in ``self.goodput`` (a
        :class:`~..obs.goodput.GoodputLedger`): ``step`` is goodput; the
        build (``compile``, ``re_warm`` after a resume), ``data_wait``,
        ``h2d``, ``metric_flush`` and ``checkpoint`` are badput;
        ``goodput_fraction`` is its fraction at the log point."""
        from ..frameworks._common.callbacks import CallbackList
        from ..obs import (
            TRAIN_COMPILE_SECONDS,
            TRAIN_H2D_BYTES,
            TRAIN_INPUT_WAIT,
            TRAIN_MFU,
            TRAIN_STEP_TIME,
            GoodputLedger,
            flight_record,
        )

        assert self.state is not None, "call init() first"
        if elastic_guard is not None:
            raise not_ported("elastic training (elastic_guard)", 7)
        run_uid = str(getattr(context, "uid", "") or "") \
            if context is not None else ""
        ledger = self.goodput = GoodputLedger(run=run_uid)
        with ledger.phase("checkpoint"):
            resumed = self._maybe_resume(checkpoint_manager, context)
        if self.compile_seconds is not None and not self._compile_attributed:
            # warmup() ran before this fit's wall window opened
            self._compile_attributed = True
            ledger.attribute("re_warm" if resumed else "compile",
                             self.compile_seconds)
        flight_record("train.fit_begin", run=run_uid, steps=steps,
                      resumed=resumed)
        hooks = CallbackList(callbacks, context=context, trainer=self)
        multihost = dist.is_initialized() and dist.get_world_size() > 1

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
            if context is not None:
                context.log_metrics(view, step=view["step"])
            else:
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
            extras["goodput_fraction"] = ledger.goodput_fraction()
            if tps > 0:
                TRAIN_STEP_TIME.set(step_tokens / tps, timer="fit")
            TRAIN_MFU.set(extras["mfu"])
            return extras

        hooks.on_train_begin()
        epoch = 0
        stopped = False
        local_stop = False   # a pending stop vote, agreed at uniform points
        if epoch_steps:
            hooks.on_epoch_begin(0)
        try:
            for step in range(steps):
                if preemption_guard is not None and \
                        preemption_guard.agreed(self.device):
                    logger.warning("preempted — checkpointing before exit",
                                   step=self.state.step)
                    if pending is not None:
                        with ledger.phase("metric_flush"):
                            last = _drain(pending)
                        pending = None
                    if checkpoint_manager is not None:
                        with ledger.phase("checkpoint"):
                            checkpoint_manager.save(self.state.step,
                                                    self.state, force=True)
                            checkpoint_manager.wait()
                        if context is not None and \
                                hasattr(context, "log_checkpoint"):
                            context.log_checkpoint(
                                checkpoint_manager.directory,
                                step=self.state.step, commit=False)
                    last = dict(last)
                    last["preempted"] = True
                    last["step"] = self.state.step
                    if context is not None and hasattr(context,
                                                       "log_result"):
                        context.log_result("preempted", True)
                    # a preempted run still finalizes its callbacks (close
                    # writers, log the tensorboard dir): their artifacts
                    # are what survives the eviction
                    hooks.on_train_end(last)
                    return last
                ledger.enter("data_wait")
                t_input = time.perf_counter()
                tokens, targets = next(data_iter)
                input_wait += time.perf_counter() - t_input
                if prefetcher is None:
                    h2d_inline += (getattr(tokens, "nbytes", 0)
                                   + getattr(targets, "nbytes", 0))
                ledger.enter("h2d")
                tokens, targets = self.shard_batch(tokens, targets)
                seq_len = tokens.shape[1]
                ledger.enter("step")
                t_dispatch = time.perf_counter()
                metrics = self._dispatch(tokens, targets)
                if step == 0 and self.compile_seconds is None:
                    # the first step builds the kernels (nvcc) inside its
                    # first launch — build-class time, kept out of goodput
                    self.compile_seconds = time.perf_counter() - t_dispatch
                    TRAIN_COMPILE_SECONDS.set(self.compile_seconds)
                    self._compile_attributed = True
                    ledger.enter("step")
                    ledger.transfer("step", "re_warm" if resumed
                                    else "compile", self.compile_seconds)
                tracker.note_step(tokens.shape[0] * seq_len)
                log_point = (step + 1) % log_every == 0 or step == steps - 1
                # non-log steps hand callbacks the raw device metrics: no
                # float() there, so the host keeps dispatching ahead of
                # the device; a callback that reads a value pays its sync
                step_metrics: dict = dict(metrics)
                if log_point:
                    extras = _extras(tokens.shape[0] * seq_len, seq_len)
                    _flush_obs()
                    if defer:
                        if pending is not None:
                            with ledger.phase("metric_flush"):
                                last = _drain(pending)
                        pending = _stage(metrics, extras)
                    else:
                        # read first (a device sync), then log: the window
                        # then holds the finished steps only
                        with ledger.phase("metric_flush"):
                            step_metrics = {k: float(v)
                                            for k, v in metrics.items()}
                            step_metrics.update(extras)
                            step_metrics["step"] = self.state.step
                            last = _log_view(step_metrics)
                    ledger.export()
                if not hooks.callbacks:
                    continue
                if not hooks.on_step_end(step, step_metrics,
                                         log_point=log_point):
                    local_stop = True
                if not multihost:
                    stopped = stopped or local_stop
                elif log_point:
                    # every rank must stop in the same step: votes are
                    # agreed at log points, step indices every rank reaches
                    stopped = all_ranks_agree(local_stop, self.device)
                if epoch_steps and ((step + 1) % epoch_steps == 0
                                    or step == steps - 1 or stopped):
                    # epoch hooks always see host floats
                    epoch_view = step_metrics if log_point else \
                        {k: float(v) for k, v in metrics.items()}
                    epoch_vote = not hooks.on_epoch_end(epoch, epoch_view)
                    local_stop = local_stop or epoch_vote
                    if not multihost:
                        stopped = stopped or epoch_vote
                    elif not stopped:
                        stopped = all_ranks_agree(local_stop, self.device)
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
                with ledger.phase("metric_flush"):
                    last = _drain(pending)
                pending = None
            hooks.on_train_end(last)
            return last
        finally:
            if pending is not None:
                # exception exit with a staged log point: land it in the
                # history/context before unwinding
                try:
                    _drain(pending)
                except Exception:  # noqa: BLE001 - the original
                    pass           # exception must win the unwind
            _flush_obs()
            ledger.close()
            if owned is not None:
                owned.close()

    @property
    def metrics_history(self) -> list[dict]:
        return list(self._metrics_history)
