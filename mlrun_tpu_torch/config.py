"""Configuration defaults the port reads — copies of the ``serving.llm``
and ``training`` blocks of ``mlrun_tpu/config.py`` (the knobs the paged
engine's and the trainer's main paths consult; the rest of those blocks
belongs to features not ported yet)."""

from __future__ import annotations

SERVING_LLM_DEFAULTS = {
    # tokens prefilled per scheduler tick (0 = whole prompt in one
    # dispatch — a long prompt then stalls running decodes)
    "prefill_chunk": 0,
    # paged engine: block-granular prompt KV reuse across requests
    "prefix_cache": True,
    # ring-buffer samples behind the p50/p95 TTFT / inter-token latency
    # percentiles in engine stats
    "latency_window": 512,
    # attention dispatch: auto picks the CUDA kernels for a CUDA device
    # and the plain paths on the CPU; flash | kernel | reference override
    "attention_impl": "auto",
}

TRAINING_DEFAULTS = {
    # device-prefetch depth: host batches pulled + copied ahead of the
    # consuming step so the H2D copy overlaps compute (0 = off)
    "prefetch": 2,
    # defer log-point metric reads via non-blocking device->host copies,
    # read one log interval later (callbacks force the synchronous path —
    # they are handed same-step host values)
    "defer_metrics": True,
    # steps excluded from the steady-state tokens_per_sec/MFU window
    # (first-step kernel build + ramp); the build time is reported
    # separately as compile_seconds
    "warmup_steps_excluded": 1,
}
