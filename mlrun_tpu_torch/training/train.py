"""Single-device train step + trainer loop — counterpart of
``mlrun_tpu/training/train.py``.

The reference jit-compiles a sharded step over a mesh; the port runs the
plain branch of ``make_train_step`` (dense, no context or pipeline
parallelism) eagerly on one device: ``loss_fn`` under autograd, gradient
accumulation, then the optax chain of ``make_optimizer`` written out
(warmup-cosine schedule, ``clip_by_global_norm``, ``adamw``) updating the
params in place. Features of the reference trainer that need many devices,
LoRA or the structured callback/elastic machinery raise
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
from ..models.llama import LlamaConfig
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
    lora_rank: int = 0          # 0 = full fine-tune; >0 = LoRA (not ported)
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


def _check_ported(train_config: TrainConfig):
    """Raise for the options the port does not have yet."""
    tc = train_config
    if tc.lora_rank > 0:
        raise not_ported("LoRA training (lora_rank > 0)", 7)
    if tc.context_parallel:
        raise not_ported("context parallelism (context_parallel)", 7)
    if tc.pipeline_stages > 1:
        raise not_ported("pipeline parallelism (pipeline_stages)", 7)
    if tc.moe_experts:
        raise not_ported("the MoE model family (moe_experts)", 9)
    if tc.mesh_shape and math.prod(
            int(n) for n in tc.mesh_shape.values() if int(n) > 0) > 1:
        raise not_ported(f"a mesh over more than one device "
                         f"(mesh_shape={tc.mesh_shape})", 7)


def resolve_model_config(model_config: LlamaConfig,
                         train_config: TrainConfig) -> LlamaConfig:
    """Apply TrainConfig model-shaping options: ``attention_impl``
    overrides the model's attention dispatch for the whole step."""
    _check_ported(train_config)
    if train_config.attention_impl is not None:
        model_config = dataclasses.replace(
            model_config, attention_impl=train_config.attention_impl)
    return model_config


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
    """Train state: the params (a tree of leaf tensors that require grad),
    the optimizer state and the host step count."""

    def __init__(self, params, opt_state: AdamWState, step: int):
        self.params = params
        self.opt_state = opt_state
        self.step = int(step)


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
    the state's params and moments updated in place. ``metrics`` holds the
    loss function's (loss, accuracy, tokens) and ``grad_norm`` (before
    clipping), all as device scalars."""
    model_config = resolve_model_config(model_config, train_config)
    accum = max(1, train_config.grad_accum)

    def compute_grads(params, tokens, targets):
        leaves = tree_leaves(params)
        loss, metrics = llama_mod.loss_fn(
            model_config, params, tokens, targets,
            loss_chunk=train_config.loss_chunk)
        grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def step_fn(state: TrainState, tokens, targets):
        if accum > 1:
            grads, metrics = accumulate_grads(
                lambda t, g: compute_grads(state.params, t, g),
                tokens, targets, accum)
        else:
            grads, metrics = compute_grads(state.params, tokens, targets)
        metrics = dict(metrics)
        metrics["grad_norm"] = optimizer.update(grads, state.opt_state,
                                                state.params)
        state.step += 1
        return state, metrics

    step_fn.compute_grads = compute_grads
    return step_fn


def init_train_state(model_config: LlamaConfig, train_config: TrainConfig,
                     optimizer: AdamW, device, seed: int = 0,
                     params=None) -> TrainState:
    """Params drawn on ``device`` from a ``torch.Generator`` seeded with
    ``seed`` (or the given ``params``, e.g. converted from the reference
    with ``models.convert.params_from_numpy``), zero moments, step 0."""
    model_config = resolve_model_config(model_config, train_config)
    if params is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        params = llama_mod.init_params(model_config, generator, device)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return TrainState(params, optimizer.init(params), 0)


def _is_structured_callback(cb) -> bool:
    return any(hasattr(cb, hook) for hook in
               ("on_step_end", "on_train_begin", "on_epoch_end"))


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

    def init(self, seed: int = 0, params=None) -> TrainState:
        self.state = init_train_state(
            self.model_config, self.train_config, self.optimizer,
            self.device, seed=seed, params=params)
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
                                   zeros[:batch_size // accum])
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
        later, so the host never waits on the device there. Callbacks —
        bare ``callback(step, metrics, trainer)`` callables fired at log
        points — force the synchronous read. ``tokens_per_sec``/``mfu``
        are steady-state (after ``warmup_steps_excluded`` steps); the
        first step's build is reported as ``compile_seconds``.
        ``goodput_fraction`` is the share of the wall time (warmup
        included) spent in steps other than the first."""
        assert self.state is not None, "call init() first"
        if elastic_guard is not None:
            raise not_ported("elastic training (elastic_guard)", 7)
        callbacks = list(callbacks or [])
        for cb in callbacks:
            if _is_structured_callback(cb) or not callable(cb):
                raise not_ported(
                    "structured Callback objects (frameworks._common)", 10)
        del epoch_steps  # only structured callbacks have epoch hooks

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
        defer = defer and not callbacks
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
                if not log_point:
                    continue
                if defer:
                    extras = _extras(seq_len)
                    if pending is not None:
                        last = _drain(pending)
                    pending = _stage(metrics, extras)
                else:
                    # read first (a device sync), then the rate: the
                    # window then holds the finished steps only
                    view = {k: float(v) for k, v in metrics.items()}
                    view.update(_extras(seq_len))
                    view["step"] = self.state.step
                    last = _log_view(view)
                    for cb in callbacks:
                        try:
                            cb(step, view, self)
                        except Exception as exc:  # noqa: BLE001 - a broken
                            # callback must not kill the run it observes
                            logger.warning("callback failed",
                                           callback=repr(cb), error=str(exc))
            if pending is not None:
                last = _drain(pending)
                pending = None
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
