"""Configuration defaults the port reads — copies of the ``serving.llm``,
``serving.fleet``, ``serving.health``, ``serving.resilience``, ``training``
and ``observability`` blocks and the ``exec_code_env`` key of
``mlrun_tpu/config.py`` (the knobs the engines', the request ledger's, the
host KV tier's, the adapter registry's, the engine fleet's, the replica
health scorer's, the trainer's and the serving graph's paths consult; the rest of those
blocks belongs to features not ported yet).

``COMPILE_CACHE_ENV`` (the reference's env mapping of
``training.compile_cache_dir``) overrides that key at read time
(``utils/compile_cache.configure_from_mlconf``)."""

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
    # per-request phase-transition ledger (obs/reqledger.py): every
    # request's wall attributed to queue_wait/prefill/decode_active/...
    # phases, exported as mlt_request_phase_seconds and returned under the
    # v2 response's opt-in "timing" field. On by default, as the
    # reference's; off = no ledger work on the hot path
    "request_ledger": True,
    # host-RAM KV tier under the paged engine's device pool
    # (serving/kv_tier.py): evicted prefix chains demote to host memory
    # and promote back on admission instead of re-prefilling from tokens.
    # Off by default — the paged engine's kv_tier arg overrides
    "kv_tier": {
        "enabled": False,
        # host-store byte budget for demoted pages (+ scales on int8)
        "host_bytes": 64 << 20,
    },
    # in-engine speculative decoding: a resident draft model proposes k
    # tokens per scheduler tick and one multi-token verify dispatch commits
    # the accepted prefix. Off by default — it needs a draft model;
    # LLMModelServer's ``speculative`` arg / the engines' ``speculative``
    # dict override these
    "speculative": {
        "enabled": False,
        # max draft tokens proposed per row per round; per-row k adapts
        # below this from the acceptance window
        "k": 4,
        # draft model preset name (models/llama MODEL_PRESETS) for
        # LLMModelServer; engines take draft_config/draft_params directly
        "draft": "",
        # rows whose windowed acceptance rate falls below this park to
        # plain decode (re-probed at k=1 periodically)
        "min_acceptance": 0.35,
        # acceptance window (verify rounds)
        "window": 32,
        # parked rows re-probe every N consulted rounds
        "probe_every": 16,
    },
    # multi-tenant LoRA serving; the engines' and LLMModelServer's
    # adapter args override these
    "adapters": {
        # device-resident adapter working set per engine (bank slots
        # beyond the base slot 0); pinning more distinct adapters in
        # flight than this fails with AdapterCapacityError (429)
        "max_live_adapters": 8,
        # deserialized adapter trees kept on the host, so an
        # evicted-then-reused adapter skips the artifact read
        "host_cache": 16,
        # per-tenant admission token bucket (requests/second + burst) in
        # front of the shared queue; 0 = fairness limiter off
        "rate": 0.0,
        "burst": 8.0,
    },
}

# engine replica fleet (serving/fleet.py); EngineFleet / LLMModelServer
# class args override these
SERVING_FLEET_DEFAULTS = {
    # affinity = consistent-hash on prompt-prefix blocks (hot prefixes stay
    # cache-resident on one replica); random is the baseline
    "routing": "affinity",
    # leading full blocks hashed into the routing key
    "route_blocks": 4,
    # virtual nodes per replica on the hash ring
    "vnodes": 64,
    # bounded re-dispatch on 503-class replica failures
    "max_dispatch_attempts": 3,
    # first re-dispatch backoff, seconds (deterministic jitter via
    # common/retry.compute_backoff)
    "backoff": 0.05,
    # cross-replica prefix-page fetch: when a hot chain's ring owner
    # changed, pull its cached pages from the previous owner over the
    # KVHandoff wire instead of re-prefilling from tokens
    "prefix_fetch": True,
}

# fail-slow replica detection (obs/health.py ReplicaHealthScorer); class
# args override these
SERVING_HEALTH_DEFAULTS = {
    "enabled": True,
    # EWMA smoothing weight on the per-tick raw score (1.0 = none)
    "ewma_alpha": 0.5,
    # robust-z thresholds: at/above suspect_z is an outlier; recovery
    # needs falling below recover_z (the gap is the hysteresis band)
    "suspect_z": 3.0,
    "recover_z": 1.5,
    # consecutive bad ticks before healthy -> suspect, further bad ticks
    # before suspect -> probation, consecutive good ticks before -> healthy
    "suspect_ticks": 2,
    "probation_ticks": 2,
    "recover_ticks": 2,
    # ring vnode weight applied on probation
    "probation_weight": 0.25,
    # probation ticks before the replica becomes a replacement candidate
    "replace_after_ticks": 20,
    # a signal is scored only when this many replicas report it
    "min_peers": 3,
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
    # persistent kernel-build cache dir ("" = disabled): nvcc's kernel
    # library and g++'s host libraries are built there and reused by the
    # next process (utils/compile_cache.py); COMPILE_CACHE_ENV overrides
    "compile_cache_dir": "",
}

COMPILE_CACHE_ENV = "MLT_TRAINING__COMPILE_CACHE_DIR"

# serving-path resilience defaults; per-step knobs in the graph spec
# override these
SERVING_RESILIENCE_DEFAULTS = {
    "drain_timeout_s": 30.0,  # GraphServer.drain bound
}

# unified telemetry read by the serving gateway and its /debug routes
OBSERVABILITY_DEFAULTS = {
    # metrics_enabled=false turns the /metrics endpoint into a 404
    # (collection itself stays on)
    "metrics_enabled": True,
    # peer gateways whose span rings join GET /debug/trace/<id>'s
    # waterfall ([] for an in-process fleet: it shares this process's ring)
    "trace_peers": [],
    # per-peer fan-out timeout of the trace assembly (a dead replica
    # degrades the waterfall after this, never 504s it)
    "trace_peer_timeout_s": 1.0,
}

# env var carrying base64 user code into the serving gateway process: its
# graph classes and handlers resolve from that code's namespace
EXEC_CODE_ENV = "MLT_EXEC_CODE"
