"""Single-device train step + trainer loop — counterpart of
``mlrun_tpu/training/train.py``.

The reference jit-compiles a sharded step over a mesh; the port runs the
plain branch of ``make_train_step`` (no context or pipeline parallelism)
eagerly on one device: the model family's loss under autograd (Llama, or
MoE with ``moe_experts``), gradient accumulation, then the optax chain of
``make_optimizer`` written out (warmup-cosine schedule,
``clip_by_global_norm``, ``adamw``) updating the params in place.
``lora_rank > 0`` trains a LoRA adapter (models/lora.py) on a frozen
Llama base: gradients and AdamW touch the adapter's tensors only. The
BERT, ViT and T5 steps build on ``make_loss_step``.
``Trainer.fit`` drives the structured callbacks of
``frameworks/_common/callbacks.py``. Features of the reference trainer
that need many devices or the elastic machinery raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import TRAINING_DEFAULTS
from ..models import llama as llama_mod
from ..models import moe as moe_mod
from ..models.llama import LlamaConfig
from ..models.moe import MoEConfig
from ..serving.resilience import not_ported
from ..utils import logger
from .data import DevicePrefetchIterator, to_device
from .mfu import ThroughputTracker, mfu


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


def _check_ported(model_config, train_config: TrainConfig):
    """Raise the reference's ``ValueError`` for MoE with LoRA or context
    parallelism (in its order, so those win), then ``NotImplementedError``
    for the options the port does not have yet."""
    tc = train_config
    if isinstance(model_config, MoEConfig):
        if tc.lora_rank > 0:
            raise ValueError("moe_experts does not compose with lora_rank "
                             "yet")
        if tc.context_parallel:
            raise ValueError(
                "moe_experts does not compose with context_parallel yet")
    if tc.context_parallel:
        raise not_ported("context parallelism (context_parallel)", 7)
    if tc.pipeline_stages > 1:
        raise not_ported("pipeline parallelism (pipeline_stages)", 7)
    if tc.mesh_shape and math.prod(
            int(n) for n in tc.mesh_shape.values() if int(n) > 0) > 1:
        raise not_ported(f"a mesh over more than one device "
                         f"(mesh_shape={tc.mesh_shape})", 7)


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


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (optax's
    ``global_norm``)."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in leaves))


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
        ``grads`` before clipping."""
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


def make_train_step(model_config: LlamaConfig, train_config: TrainConfig,
                    optimizer: AdamW) -> Callable:
    """The plain step: (state, tokens, targets) -> (state, metrics), with
    the state's trained tree (the params, or the LoRA adapter) and moments
    updated in place. ``metrics`` holds the loss function's (loss,
    accuracy, tokens) and ``grad_norm`` (before clipping), all as device
    scalars."""
    model_config = resolve_model_config(model_config, train_config)
    accum = max(1, train_config.grad_accum)
    family_loss, _ = _model_api(model_config)

    def compute_grads(params, tokens, targets, lora=None):
        """Gradients of the loss with respect to ``lora``'s leaves when an
        adapter is given (the base is frozen), else ``params``' leaves."""
        leaves = tree_leaves(params if lora is None else lora)
        loss, metrics = family_loss(
            model_config, params, tokens, targets,
            loss_chunk=train_config.loss_chunk, lora=lora)
        grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def step_fn(state: TrainState, tokens, targets):
        if accum > 1:
            grads, metrics = accumulate_grads(
                lambda t, g: compute_grads(state.params, t, g, state.lora),
                tokens, targets, accum)
        else:
            grads, metrics = compute_grads(state.params, tokens, targets,
                                           state.lora)
        metrics = dict(metrics)
        metrics["grad_norm"] = optimizer.update(grads, state.opt_state,
                                                state.trained)
        state.step += 1
        return state, metrics

    step_fn.compute_grads = compute_grads
    return step_fn


def make_loss_step(loss: Callable, optimizer: AdamW, mesh=None,
                   with_grad_norm: bool = True) -> Callable:
    """The single-device train step of the BERT, ViT and T5 families:
    ``step(params, opt_state, *batch) -> (params, opt_state, metrics)``.
    ``loss(params, *batch) -> (loss, metrics)`` is differentiated with
    autograd over every leaf of ``params`` (each set to require grad), and
    ``optimizer`` updates the params and ``opt_state`` in place;
    ``metrics`` gains the pre-clip ``grad_norm`` when ``with_grad_norm``.
    ``step.compute_grads(params, *batch)`` returns (grads in
    ``tree_leaves`` order, metrics) without updating. A mesh (the
    reference's sharded step) waits for training on many GPUs."""
    if mesh is not None:
        raise not_ported("a sharded train step (mesh)", 7)

    def compute_grads(params, *batch):
        leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(params)]
        value, metrics = loss(params, *batch)
        grads = torch.autograd.grad(value, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

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
                     params=None, lora=None) -> TrainState:
    """Params drawn on ``device`` from a ``torch.Generator`` seeded with
    ``seed`` (or the given ``params``, e.g. converted from the reference
    with ``models.convert.params_from_numpy``), zero moments, step 0.
    With ``lora_rank > 0`` the params are frozen and an adapter
    (``models.lora.init_lora``: A random, B zero, drawn from the same
    generator after the params, or the given ``lora``) is trained."""
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
    for leaf in tree_leaves(params):
        leaf.requires_grad_(not is_lora)
    if not is_lora:
        return TrainState(params, optimizer.init(params), 0)
    for leaf in tree_leaves(lora):
        leaf.requires_grad_(True)
    return TrainState(params, optimizer.init(lora), 0, lora)


class Trainer:
    """High-level trainer used by the torch framework adapter and
    ``chip_smoke.py``: ``init`` -> ``warmup`` -> ``fit``. Runs on CUDA
    unless ``device="cpu"`` is passed."""

    def __init__(self, model_config: LlamaConfig,
                 train_config: TrainConfig | None = None,
                 device: torch.device | str | None = None):
        self.train_config = train_config or TrainConfig()
        self.model_config = resolve_model_config(model_config,
                                                 self.train_config)
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' for the plain CPU path")
        self.optimizer = make_optimizer(self.train_config)
        self.step_fn = make_train_step(self.model_config, self.train_config,
                                       self.optimizer)
        self.state: Optional[TrainState] = None
        self._metrics_history: list[dict] = []
        # warmup() product: wall seconds of the kernel build + first pass
        self.compile_seconds: Optional[float] = None
        self._compile_attributed = False

    def init(self, seed: int = 0, params=None, lora=None) -> TrainState:
        self.state = init_train_state(
            self.model_config, self.train_config, self.optimizer,
            self.device, seed=seed, params=params, lora=lora)
        return self.state

    def warmup(self, batch_size: int, seq_len: int) -> dict:
        """Build the CUDA kernels (nvcc at first use) and run one forward
        and backward on a zero batch of ``(batch_size, seq_len)`` whose
        gradients are dropped — nothing persistent changes. Its wall time
        is ``compile_seconds``, kept out of the steady-state throughput."""
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
        logger.info("train step warmed up", batch=batch_size, seq=seq_len,
                    compile_s=round(self.compile_seconds, 3))
        return {"compile_seconds": self.compile_seconds,
                "batch_size": batch_size, "seq_len": seq_len}

    def train_step(self, tokens, targets) -> dict:
        tokens, targets = to_device((tokens, targets), self.device)
        return self._dispatch(tokens, targets)

    def _dispatch(self, tokens, targets) -> dict:
        self.state, metrics = self.step_fn(self.state, tokens, targets)
        return metrics

    def fit(self, data_iter, steps: int, context=None,
            log_every: int = 10, callbacks: list | None = None,
            checkpoint_manager=None, preemption_guard=None,
            elastic_guard=None, epoch_steps: int = 0,
            prefetch: int | None = None,
            defer_metrics: bool | None = None) -> dict:
        """Run the training loop; logs metrics to ``context`` (duck-typed
        ``log_metrics(metrics, step=)``) at log points. With
        ``preemption_guard`` + ``checkpoint_manager``, a SIGTERM triggers
        one final synchronous checkpoint and an early return with
        ``preempted: True``.

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
        stops the loop with ``stopped_early: True``) and bare
        ``callback(step, metrics, trainer)`` callables, fired at log
        points. ``tokens_per_sec``/``mfu`` are steady-state (after
        ``warmup_steps_excluded`` steps); the first step's build is
        reported as ``compile_seconds``. ``goodput_fraction`` is the
        share of the wall time (warmup included) spent in steps other
        than the first."""
        from ..frameworks._common.callbacks import CallbackList

        assert self.state is not None, "call init() first"
        if elastic_guard is not None:
            raise not_ported("elastic training (elastic_guard)", 7)
        hooks = CallbackList(callbacks, context=context, trainer=self)

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
        fit_start = time.perf_counter()
        badput = 0.0
        if self.compile_seconds is not None and not self._compile_attributed:
            # warmup() ran before this fit's wall window opened
            self._compile_attributed = True
            badput = self.compile_seconds
        step_seconds = 0.0
        input_wait = 0.0
        pending = None
        last: dict = {}

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

        def _extras(seq_len: int) -> dict:
            tps = tracker.tokens_per_sec()
            extras = {
                "tokens_per_sec": tps,
                "tokens_per_sec_per_chip": tps,
                "mfu": mfu(tps, self.model_config.flops_per_token(seq_len),
                           device=self.device),
                "input_wait_seconds": input_wait,
            }
            if self.compile_seconds is not None:
                extras["compile_seconds"] = self.compile_seconds
            wall = time.perf_counter() - fit_start + badput
            extras["goodput_fraction"] = step_seconds / wall if wall else 0.0
            return extras

        hooks.on_train_begin()
        epoch = 0
        if epoch_steps:
            hooks.on_epoch_begin(0)
        try:
            for step in range(steps):
                if preemption_guard is not None and preemption_guard.agreed():
                    logger.warning("preempted — checkpointing before exit",
                                   step=self.state.step)
                    if pending is not None:
                        last = _drain(pending)
                        pending = None
                    if checkpoint_manager is not None:
                        checkpoint_manager.save(self.state.step, self.state,
                                                force=True)
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
                t_input = time.perf_counter()
                tokens, targets = next(data_iter)
                input_wait += time.perf_counter() - t_input
                if prefetcher is None:
                    tokens, targets = to_device((tokens, targets),
                                                self.device)
                seq_len = tokens.shape[1]
                t_dispatch = time.perf_counter()
                metrics = self._dispatch(tokens, targets)
                elapsed = time.perf_counter() - t_dispatch
                if step == 0 and self.compile_seconds is None:
                    # the first step builds the kernels (nvcc) inside its
                    # first launch — build-class time, kept out of goodput
                    self.compile_seconds = elapsed
                    self._compile_attributed = True
                else:
                    step_seconds += elapsed
                tracker.note_step(tokens.shape[0] * seq_len)
                log_point = (step + 1) % log_every == 0 or step == steps - 1
                # non-log steps hand callbacks the raw device metrics: no
                # float() there, so the host keeps dispatching ahead of
                # the device; a callback that reads a value pays its sync
                step_metrics: dict = dict(metrics)
                if log_point and defer:
                    extras = _extras(seq_len)
                    if pending is not None:
                        last = _drain(pending)
                    pending = _stage(metrics, extras)
                elif log_point:
                    # read first (a device sync), then the rate: the
                    # window then holds the finished steps only
                    step_metrics = {k: float(v) for k, v in metrics.items()}
                    step_metrics.update(_extras(seq_len))
                    step_metrics["step"] = self.state.step
                    last = _log_view(step_metrics)
                if not hooks.callbacks:
                    continue
                # one process: a stop vote takes effect in its own step
                # (the reference agrees it across hosts at log points)
                stopped = not hooks.on_step_end(step, step_metrics,
                                                log_point=log_point)
                if epoch_steps and ((step + 1) % epoch_steps == 0
                                    or step == steps - 1 or stopped):
                    # epoch hooks always see host floats
                    epoch_view = step_metrics if log_point else \
                        {k: float(v) for k, v in metrics.items()}
                    if not hooks.on_epoch_end(epoch, epoch_view):
                        stopped = True
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
            if owned is not None:
                owned.close()

    @property
    def metrics_history(self) -> list[dict]:
        return list(self._metrics_history)
