"""Torch auto-trainer — counterpart of
``mlrun_tpu/frameworks/jax/auto_trainer.py``.

``train(...)`` runs a full fine-tune of a Llama-family model on one device
(CUDA unless ``device="cpu"``): streams data, warms the step up (kernel
build), fits with per-step metrics logged to a duck-typed run context,
checkpoints with ``training.CheckpointManager`` and exits cleanly on
SIGTERM, and returns the final metrics with ``train_time_s``. The handler
contract is the reference's, with the same defaults; features the port does
not have yet (LoRA, meshes over many devices, context and pipeline
parallelism, MoE, text datasets, structured callbacks) raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterator

from ...models.llama import MODEL_PRESETS, LlamaConfig
from ...serving.resilience import not_ported
from ...utils import logger

__all__ = ["MODEL_PRESETS", "train"]


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
    """A tokens ``.npy`` file as an LM batch stream; the synthetic stream
    when no dataset is given. Text datasets need a tokenizer, which the
    port does not have yet."""
    from ...training.data import array_token_stream, synthetic_token_stream

    if not dataset:
        return synthetic_token_stream(batch_size, seq_len, vocab_size,
                                      seed=seed)
    if dataset.endswith(".npy"):
        import numpy as np

        return array_token_stream(np.load(dataset), batch_size, seq_len,
                                  seed=seed)
    raise not_ported("text datasets (tokenizers)", 10)


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
    mfu, ..., step, train_time_s)."""
    from ...training import (
        CheckpointManager,
        PreemptionGuard,
        TrainConfig,
        Trainer,
    )

    if early_stop or tensorboard:
        raise not_ported("early_stop / tensorboard callbacks", 10)
    model_config = _resolve_model_config(model, model_overrides)
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
        def _periodic_checkpoint(step, metrics, trainer_):
            if trainer_.state.step % checkpoint_every == 0:
                manager.save(trainer_.state.step, trainer_.state)

        callbacks.append(_periodic_checkpoint)

    if warmup:
        warm = trainer.warmup(batch_size, seq_len)
        if context is not None and hasattr(context, "log_result"):
            context.log_result("compile_seconds", warm["compile_seconds"])

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
    if context is not None and hasattr(context, "log_results"):
        context.log_results(final_metrics)

    if manager is not None:
        manager.save(trainer.state.step, trainer.state, force=True)
        manager.wait()
        if context is not None and hasattr(context, "log_model"):
            context.log_model(
                model_name, model_dir=manager.directory, framework="torch",
                metrics={"loss": final_metrics.get("loss"),
                         "mfu": final_metrics.get("mfu")},
                parameters={"model": str(model), "lora_rank": lora_rank,
                            "steps": steps, "seq_len": seq_len},
                upload=False, target_path=manager.directory)
        manager.close()
    return final_metrics
