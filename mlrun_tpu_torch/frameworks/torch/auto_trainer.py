"""Torch auto-trainer — counterpart of
``mlrun_tpu/frameworks/jax/auto_trainer.py``.

``train(...)`` runs a full fine-tune of a Llama-family model (MoE with
``moe_experts``) or trains a LoRA adapter (CUDA unless
``device="cpu"``): streams data (synthetic, a tokens ``.npy`` or a text
file through a tokenizer), warms the step up (kernel build), fits with
per-step metrics logged to a duck-typed run context and the structured
callbacks (checkpoint every N steps, early stop, TensorBoard, the
caller's), checkpoints with ``training.CheckpointManager`` and exits
cleanly on SIGTERM, and returns the final metrics with ``train_time_s``.
``evaluate(...)`` averages the loss metrics over a few batches. A
dataset may be a datastore url (``file://``). ``mesh_shape``
trains (and evaluates) over a ``data`` x ``fsdp`` x ``tensor`` mesh of
the process group (with ``moe_experts``, an ``expert`` axis holds the
experts), ``context_parallel`` over a ``seq`` axis,
``pipeline_stages`` over a ``pipe`` axis (by default the stages on
``pipe`` and the rest of the ranks on ``data``, as the reference). The
handler contract is the reference's, with the same defaults.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterator

from ...execution import logging_worker
from ...models.llama import MODEL_PRESETS, LlamaConfig
from ...utils import logger

__all__ = ["MODEL_PRESETS", "TorchTrainerInterface", "apply_mlrun",
           "evaluate", "train"]


def apply_mlrun(model=None, context=None, model_name: str = "model",
                tag: str = "", **kwargs):
    """Wrap a (model_config, params) pair with context logging hooks."""
    return TorchTrainerInterface(model=model, context=context,
                                 model_name=model_name, tag=tag, **kwargs)


class TorchTrainerInterface:
    """Lifecycle hooks around a training loop (metric logging and model
    registration in a duck-typed run context), the reference's
    ``JaxTrainerInterface``."""

    def __init__(self, model=None, context=None, model_name="model", tag="",
                 **kwargs):
        self.model = model
        self.context = context
        self.model_name = model_name
        self.tag = tag
        self._extra = kwargs

    def log_metrics(self, metrics: dict, step: int | None = None):
        if self.context is not None:
            self.context.log_metrics(metrics, step=step)

    def log_model(self, checkpoint_dir: str = "", metrics: dict | None = None,
                  parameters: dict | None = None, framework: str = "torch"):
        if self.context is None:
            return None
        return self.context.log_model(
            self.model_name, model_dir=checkpoint_dir or None,
            framework=framework, metrics=metrics, parameters=parameters,
            upload=False, target_path=checkpoint_dir or None, tag=self.tag)


def _resolve_model_config(model: str | LlamaConfig | dict,
                          overrides: dict | None = None) -> LlamaConfig:
    if isinstance(model, LlamaConfig):
        config = model
    elif isinstance(model, dict):
        config = LlamaConfig(**model)
    elif isinstance(model, str):
        preset = MODEL_PRESETS.get(model)
        if preset is None:
            raise ValueError(
                f"unknown model preset '{model}' "
                f"(have {sorted(MODEL_PRESETS)})")
        config = preset()
    else:
        raise ValueError(f"unsupported model spec {model!r}")
    if overrides:
        config = dataclasses.replace(config, **overrides)
    return config


def _make_stream(dataset: str | None, tokenizer: str | None, batch_size: int,
                 seq_len: int, vocab_size: int, seed: int) -> Iterator:
    """A dataset path or datastore url (tokens ``.npy``, or text through
    the tokenizer ``tokenizer`` names) as an LM batch stream; the
    synthetic stream when no dataset is given."""
    from ...training.data import (
        array_token_stream,
        synthetic_token_stream,
        text_file_stream,
    )

    if not dataset:
        return synthetic_token_stream(batch_size, seq_len, vocab_size,
                                      seed=seed)
    import numpy as np

    from ...datastore import store_manager

    local = store_manager.object(url=dataset).local()
    if local.endswith(".npy"):
        return array_token_stream(np.load(local), batch_size, seq_len,
                                  seed=seed)
    if not tokenizer:
        raise ValueError("text datasets need a tokenizer= id")
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tokenizer)
    return text_file_stream(local, tok, batch_size, seq_len, seed=seed)


def _world_size() -> int:
    """The process group's size (the launcher's ``WORLD_SIZE`` before it
    is joined; 1 without one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def train(context=None,
          model: str | LlamaConfig | dict = "tiny",
          model_overrides: dict | None = None,
          dataset: str | None = None,
          tokenizer: str | None = None,
          batch_size: int = 8,
          seq_len: int = 512,
          steps: int = 100,
          learning_rate: float = 2e-4,
          lora_rank: int = 0,
          lora_alpha: float = 32.0,
          grad_accum: int = 1,
          mesh_shape: dict | None = None,
          context_parallel: str | None = None,
          seq_axis: str | None = None,
          pipeline_stages: int = 0,
          pipeline_microbatches: int = 0,
          moe_experts: int = 0,
          moe_top_k: int = 2,
          moe_capacity_factor: float = 1.25,
          checkpoint_dir: str = "",
          checkpoint_every: int = 0,
          resume: bool = True,
          epoch_steps: int = 0,
          early_stop: dict | None = None,
          tensorboard: bool = False,
          callbacks: list | None = None,
          model_name: str = "model",
          log_every: int = 10,
          seed: int = 0,
          prefetch: int | None = None,
          warmup: bool = True,
          device: str | None = None) -> dict:
    """Run a full fine-tune end to end inside a run context; returns the
    final metrics (loss, accuracy, tokens, grad_norm, tokens_per_sec,
    mfu, ..., step, train_time_s; ``stopped_early`` when a callback
    stopped it). ``early_stop`` holds ``EarlyStoppingCallback``'s
    arguments (e.g. ``{"monitor": "loss", "patience": 3}``);
    ``tensorboard=True`` writes TensorBoard summaries and logs them as
    the ``<model_name>-tensorboard`` artifact; ``checkpoint_every`` saves
    every N steps."""
    from .._common.callbacks import (
        CheckpointCallback,
        EarlyStoppingCallback,
        TensorBoardCallback,
    )
    from ...training import (
        CheckpointManager,
        PreemptionGuard,
        TrainConfig,
        Trainer,
    )

    model_config = _resolve_model_config(model, model_overrides)
    if pipeline_stages and not mesh_shape:
        # the reference's default: the stages on 'pipe', the rest on 'data'
        n = _world_size()
        if n % pipeline_stages:
            raise ValueError(
                f"pipeline_stages={pipeline_stages} does not divide "
                f"{n} devices; pass mesh_shape explicitly")
        mesh_shape = {"data": n // pipeline_stages, "pipe": pipeline_stages}
    train_config = TrainConfig(
        learning_rate=learning_rate, total_steps=steps, lora_rank=lora_rank,
        lora_alpha=lora_alpha, grad_accum=grad_accum, mesh_shape=mesh_shape,
        context_parallel=context_parallel,
        seq_axis=seq_axis or ("seq" if context_parallel else None),
        pipeline_stages=pipeline_stages,
        pipeline_microbatches=pipeline_microbatches,
        moe_experts=moe_experts, moe_top_k=moe_top_k,
        moe_capacity_factor=moe_capacity_factor)
    trainer = Trainer(model_config, train_config, device=device)
    trainer.init(seed)

    stream = _make_stream(dataset, tokenizer, batch_size, seq_len,
                          model_config.vocab_size, seed)

    manager = None
    if checkpoint_dir or checkpoint_every:
        checkpoint_dir = checkpoint_dir or os.path.join(
            getattr(context, "artifact_path", "") or os.getcwd(),
            "checkpoints", model_name)
        manager = CheckpointManager(checkpoint_dir)
        if resume and manager.latest_step() is not None:
            trainer.state = manager.restore(trainer.state)
            logger.info("resumed from checkpoint", step=trainer.state.step)

    callbacks = list(callbacks or [])
    if manager is not None and checkpoint_every:
        callbacks.append(CheckpointCallback(manager,
                                            every_steps=checkpoint_every))
    if early_stop:
        callbacks.append(EarlyStoppingCallback(**early_stop))
    if tensorboard:
        callbacks.append(TensorBoardCallback(
            name=f"{model_name}-tensorboard"))
    interface = apply_mlrun(context=context, model_name=model_name)
    # results and the model are logged from the logging worker only (the
    # reference's run context gates its writes the same way)
    logs = context is not None and logging_worker(context)

    if warmup:
        try:
            warm = trainer.warmup(batch_size, seq_len)
        except Exception as exc:  # noqa: BLE001 - a failed warmup (a build
            # error, an out-of-memory) degrades to a first-step build
            logger.warning("warmup failed — compiling on first step",
                           error=str(exc))
        else:
            if logs and warm.get("compile_seconds") \
                    and hasattr(context, "log_result"):
                context.log_result("compile_seconds",
                                   warm["compile_seconds"])

    guard = PreemptionGuard().install()
    start = time.perf_counter()
    try:
        final_metrics = trainer.fit(
            stream, steps=steps, context=context, log_every=log_every,
            callbacks=callbacks, checkpoint_manager=manager,
            preemption_guard=guard, epoch_steps=epoch_steps,
            prefetch=prefetch)
    finally:
        guard.restore()
    elapsed = time.perf_counter() - start

    final_metrics = {k: (v if isinstance(v, bool) else float(v))
                     for k, v in final_metrics.items()}
    final_metrics["train_time_s"] = elapsed
    if logs and hasattr(context, "log_results"):
        context.log_results(final_metrics)

    if manager is not None:
        manager.save(trainer.state.step, trainer.state, force=True)
        manager.wait()
        if logs:
            interface.log_model(
                checkpoint_dir=manager.directory, metrics={
                    "loss": final_metrics.get("loss"),
                    "mfu": final_metrics.get("mfu"),
                },
                parameters={"model": str(model), "lora_rank": lora_rank,
                            "steps": steps, "seq_len": seq_len})
        manager.close()
    return final_metrics


def evaluate(context=None,
             model: str | LlamaConfig | dict = "tiny",
             model_overrides: dict | None = None,
             checkpoint_dir: str = "", dataset: str | None = None,
             tokenizer: str | None = None,
             batch_size: int = 8, seq_len: int = 512, steps: int = 10,
             mesh_shape: dict | None = None, seed: int = 0,
             device: str | None = None) -> dict:
    """Average ``loss_fn``'s metrics over ``steps`` batches into
    ``eval_<key>``, on params restored from the latest checkpoint under
    ``checkpoint_dir`` (either form; else drawn from ``seed``); runs on
    CUDA unless ``device="cpu"``. With ``mesh_shape`` every rank holds the
    params, evaluates its slice of each batch (over ``data`` x ``fsdp``)
    and the metrics are averaged over the ranks."""
    import torch

    from ...models import llama as llama_mod
    from ...parallel.mesh import make_mesh
    from ...parallel.sharding import batch_sharding, local_part, mean_metrics
    from ...serving.llm import default_device
    from ...training import CheckpointManager
    from ...training.data import to_device
    from ...training.train import TrainConfig, _check_options

    model_config = _resolve_model_config(model, model_overrides)
    _check_options(model_config, TrainConfig(mesh_shape=mesh_shape))
    device = default_device(device)
    mesh = make_mesh(mesh_shape, device) if mesh_shape else None
    if checkpoint_dir:
        # the params alone: the optimizer state never reaches the host
        params = CheckpointManager(checkpoint_dir).restore_params(
            device=device)
    else:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        params = llama_mod.init_params(model_config, generator, device)
    stream = _make_stream(dataset, tokenizer, batch_size, seq_len,
                          model_config.vocab_size, seed)
    totals: dict = {}
    with torch.no_grad():
        for _ in range(steps):
            tokens, targets = to_device(next(stream), device)
            if mesh is not None:
                tokens, targets = (local_part(x, mesh, batch_sharding(mesh))
                                   for x in (tokens, targets))
            _, metrics = llama_mod.loss_fn(model_config, params, tokens,
                                           targets)
            if mesh is not None:
                metrics = mean_metrics(metrics, mesh)
            for key, value in metrics.items():
                totals[key] = totals.get(key, 0.0) + float(value)
    results = {f"eval_{k}": v / steps for k, v in totals.items()}
    if context is not None and logging_worker(context):
        context.log_results(results)
    return results
