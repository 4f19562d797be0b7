"""Telemetry of the port's serving engines: the metrics registry, the
request ledger, the flight recorder and the tracer — copies of the
``mlrun_tpu/obs`` modules the engines reach, with the reference's metric
names and labels (``mlt_*``), so one scrape config reads both packages.

This package owns the canonical engine families so every render exposes
the same schema before a sample lands. Producers import the family
objects from here; consumers render ``REGISTRY``. ``health`` holds the
fail-slow replica scorer of the engine fleet, ``goodput`` the training
run's goodput ledger; the five ``mlt_train_*`` / ``mlt_training_mfu``
families are the trainer's, the six serving-graph families the graph
server's and its HTTP gateway's. ``traceview`` assembles one request's
waterfall and ``debug`` holds the gateway's ``/debug`` handler cores. The
reference's federation, SLO and time-series modules belong to item 6's
remainder (ROADMAP.md).
"""

import threading as _threading

from .flight import FlightRecorder, get_flight_recorder  # noqa: F401
from .flight import record as flight_record  # noqa: F401
from .metrics import (  # noqa: F401
    CONTENT_TYPE,
    DEFAULT_BUCKETS,
    OPENMETRICS_CONTENT_TYPE,
    REGISTRY,
    CardinalityError,
    Counter,
    Gauge,
    Histogram,
    MetricError,
    MetricsRegistry,
    wants_openmetrics,
)
from .reqledger import (  # noqa: F401
    REQUEST_PHASE_SECONDS,
    RequestLedger,
    export_phases,
    ledger_enabled,
    merge_timing,
    retire_adapter_phases,
)
from .stats import nearest_rank  # noqa: F401
from .tracing import (  # noqa: F401
    TRACE_HEADER,
    Span,
    Tracer,
    format_trace_header,
    get_tracer,
    new_trace_id,
    parse_trace_header,
)

# -- serving graph -----------------------------------------------------------
REQUEST_LATENCY = REGISTRY.histogram(
    "mlt_request_latency_seconds",
    "End-to-end GraphServer.run latency per event")
STEP_LATENCY = REGISTRY.histogram(
    "mlt_step_latency_seconds",
    "Per-step execution latency in the serving graph",
    labels=("step",), overflow="drop")
SERVING_EVENTS = REGISTRY.counter(
    "mlt_serving_events_total",
    "Serving-path events mirrored from context.metrics (breaker trips, "
    "admission rejects, sheds, deadline expiries, drain rejections)",
    labels=("event",), overflow="drop")
PROBE_REQUESTS = REGISTRY.counter(
    "mlt_probe_requests_total",
    "Probe/scrape endpoint hits (healthz/readyz/stats/metrics) — counted "
    "here, excluded from request telemetry and never traced",
    labels=("path",), overflow="drop")
BREAKER_STATE = REGISTRY.gauge(
    "mlt_breaker_state",
    "Circuit breaker state per step (0 closed, 1 half-open, 2 open)",
    labels=("step",), overflow="drop")
SERVER_INFLIGHT = REGISTRY.gauge(
    "mlt_server_inflight", "In-flight events on the graph server")

# -- LLM engines -------------------------------------------------------------
# every family carries a ``replica`` label (empty for standalone engines);
# the TTFT/ITL/queue families also carry a bounded ``adapter`` label ("" =
# base model). Engines remove their own series on stop
LLM_TTFT = REGISTRY.histogram(
    "mlt_llm_ttft_seconds", "Time to first token (continuous batching)",
    labels=("replica", "adapter"), max_label_sets=256, overflow="drop")
LLM_ITL = REGISTRY.histogram(
    "mlt_llm_itl_seconds",
    "Inter-token latency: whole scheduler iterations that produced a "
    "decode step (observed once per adapter active in the tick)",
    labels=("replica", "adapter"), max_label_sets=256, overflow="drop",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5))
LLM_DECODE_TICK = REGISTRY.histogram(
    "mlt_llm_decode_tick_seconds",
    "One decode dispatch (host-observed, admission prefill excluded) — "
    "the attention-dominated device step the paged/flash kernels target",
    labels=("replica",), max_label_sets=128, overflow="drop",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5))
LLM_QUEUE_DEPTH = REGISTRY.gauge(
    "mlt_llm_queue_depth",
    "Queued + pending admissions per engine, split by adapter (the "
    "adapter=\"\" series carries the base/untenanted remainder, so the "
    "sum over adapter label values is the engine's total depth)",
    labels=("engine", "replica", "adapter"), max_label_sets=512,
    overflow="drop")
LLM_FREE_PAGE_FRAC = REGISTRY.gauge(
    "mlt_llm_free_page_frac",
    "Free (incl. reclaimable prefix) KV-page fraction, paged engines",
    labels=("engine", "replica"), overflow="drop")
LLM_EVENTS = REGISTRY.counter(
    "mlt_llm_events_total",
    "Cumulative engine events mirrored from stats() (requests, completed, "
    "shed, expired, prefix_hits, prefix_evictions, ...)",
    labels=("engine", "replica", "event"), max_label_sets=1024,
    overflow="drop")
LLM_SPEC_ROUNDS = REGISTRY.counter(
    "mlt_llm_spec_rounds_total",
    "Speculative verify rounds (one multi-token verify dispatch covers "
    "every speculating row in the tick; each speculating row counts one "
    "round)",
    labels=("engine", "replica"), max_label_sets=512, overflow="drop")
LLM_SPEC_TOKENS = REGISTRY.counter(
    "mlt_llm_spec_tokens_total",
    "Draft tokens by verify outcome: accepted (matched the target "
    "argmax) vs rejected (rolled back on the KV by pos-rewind) — "
    "accepted/(accepted+rejected) is the fleet acceptance rate",
    labels=("engine", "replica", "outcome"), max_label_sets=512,
    overflow="drop")
# the host KV tier (serving/kv_tier.py): fed event-side from the paged
# engine, removed on engine stop like the rest of the per-engine families
KV_TIER_BYTES = REGISTRY.gauge(
    "mlt_kv_tier_bytes",
    "Host-KV-tier bytes resident (demoted int8 pages + scales) per "
    "paged engine",
    labels=("engine", "replica"), overflow="drop")
KV_TIER_HITS = REGISTRY.counter(
    "mlt_kv_tier_hits_total",
    "Prefix-block admissions served by cache tier: device (page-pool "
    "radix hit), host (promote from the host tier), remote "
    "(cross-replica page fetch)",
    labels=("engine", "replica", "tier"), max_label_sets=512,
    overflow="drop")
KV_TIER_EVENTS = REGISTRY.counter(
    "mlt_kv_tier_events_total",
    "Hierarchical-KV movement by op (demote / promote / fetch) and "
    "outcome (ok / miss / fallback / error) — error and fallback "
    "outcomes degrade to plain token prefill, never a client error",
    labels=("engine", "replica", "op", "outcome"), max_label_sets=512,
    overflow="drop")

# -- multi-tenant adapters (serving/adapters.py) -----------------------------
ADAPTER_LIVE = REGISTRY.gauge(
    "mlt_adapter_live",
    "LoRA adapters currently resident in the engine's device bank "
    "(working set, base slot excluded)",
    labels=("engine", "replica"), overflow="drop")
ADAPTER_LOADS = REGISTRY.counter(
    "mlt_adapter_loads_total",
    "Adapter registry outcomes: ok (device load), evict (LRU "
    "displacement), error (failed artifact load), capacity (429 "
    "working-set full), unknown (404 bad tenant id), rate_limited "
    "(per-tenant fairness shed)",
    labels=("engine", "replica", "outcome"), max_label_sets=512,
    overflow="drop")

# -- engine fleet (serving/fleet.py) -----------------------------------------
FLEET_DISPATCHES = REGISTRY.counter(
    "mlt_fleet_dispatches_total",
    "Fleet routing outcomes per replica (ok / redispatch / failed / "
    "no_replica)",
    labels=("replica", "outcome"), max_label_sets=512, overflow="drop")
FLEET_HANDOFF_BYTES = REGISTRY.counter(
    "mlt_fleet_handoff_bytes_total",
    "KV bytes moved prefill-replica -> decode-replica (the batch=1 "
    "slot-cache serialization boundary)")
FLEET_HANDOFF_LATENCY = REGISTRY.histogram(
    "mlt_fleet_handoff_seconds",
    "Prefill-complete -> decode-slot-active latency for disaggregated "
    "requests (decode-side import + queueing)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5))
FLEET_REPLICAS = REGISTRY.gauge(
    "mlt_fleet_replicas", "Live fleet replicas by role",
    labels=("role",), overflow="drop")
REPLICA_HEALTH_SCORE = REGISTRY.gauge(
    "mlt_replica_health_score",
    "EWMA-smoothed peer-relative badness (robust z over the fleet "
    "median; obs/health.py ReplicaHealthScorer) — 0 is median-healthy, "
    "above suspect_z the replica is a fail-slow outlier",
    labels=("replica",), max_label_sets=512, overflow="drop")
REPLICA_HEALTH_STATE = REGISTRY.gauge(
    "mlt_replica_health_state",
    "Replica health state machine position (0 healthy, 1 suspect, "
    "2 probation; retired with the replica's other series on stop)",
    labels=("replica",), max_label_sets=512, overflow="drop")
HEALTH_TRANSITIONS = REGISTRY.counter(
    "mlt_health_transitions_total",
    "Health state-machine transitions per replica, labeled by the state "
    "entered (suspect / probation / healthy)",
    labels=("replica", "to"), max_label_sets=512, overflow="drop")

# -- canary splits (serving/canary.py) ---------------------------------------
CANARY_REQUESTS = REGISTRY.counter(
    "mlt_canary_requests_total",
    "Requests resolved through the canary hash split, by side (the "
    "adapter label is the TENANT id, not the versioned adapter id)",
    labels=("adapter", "side"), max_label_sets=512, overflow="drop")

# -- chaos -------------------------------------------------------------------
CHAOS_FIRED = REGISTRY.counter(
    "mlt_chaos_fired_total",
    "Armed fault injections whose effect actually fired, by point",
    labels=("point",), overflow="drop")

# -- training ----------------------------------------------------------------
TRAIN_MFU = REGISTRY.gauge(
    "mlt_training_mfu", "Last computed model FLOPs utilization")
TRAIN_STEP_TIME = REGISTRY.gauge(
    "mlt_train_step_seconds", "Last step wall time per StepTimer",
    labels=("timer",), overflow="drop")
TRAIN_INPUT_WAIT = REGISTRY.counter(
    "mlt_train_input_wait_seconds",
    "Cumulative seconds the training loop spent blocked waiting on the "
    "input pipeline (next(data_iter)) — a growing rate proves the run is "
    "input-bound, not FLOPs-bound")
TRAIN_H2D_BYTES = REGISTRY.counter(
    "mlt_train_h2d_bytes_total",
    "Host->device batch bytes issued by the training input path "
    "(device prefetch stage or inline shard_batch)")
TRAIN_COMPILE_SECONDS = REGISTRY.gauge(
    "mlt_train_compile_seconds",
    "Wall seconds of the last train-step build (Trainer.warmup or the "
    "first fit step: the CUDA kernels' nvcc build and the first pass)")
TRAIN_LOADER_OCCUPANCY = REGISTRY.gauge(
    "mlt_train_loader_ring_occupancy",
    "Staged batches currently in the native TokenShardLoader ring buffer "
    "(0 with consumer waits climbing = input-bound)",
    labels=("loader",), overflow="drop")
TRAIN_LOADER_EVENTS = REGISTRY.counter(
    "mlt_train_loader_events_total",
    "Cumulative TokenShardLoader counters mirrored from stats() "
    "(batches, consumer_waits, producer_waits, epochs)",
    labels=("loader", "event"), max_label_sets=512, overflow="drop")

from .goodput import GoodputLedger  # noqa: E402,F401

# -- memory (scrape-time) ----------------------------------------------------
DEVICE_MEM = REGISTRY.gauge(
    "mlt_device_mem_bytes",
    "Device memory snapshot per accelerator (kind = in_use | peak | "
    "limit), read at scrape time by the weakref collector trainers and "
    "LLM engines register (register_memory_collector)",
    labels=("device", "kind"), max_label_sets=512, overflow="drop")
HOST_RSS = REGISTRY.gauge(
    "mlt_host_rss_bytes",
    "Resident set size of this process (VmRSS), scrape-time")


def memory_sample() -> dict:
    """Numeric memory snapshot for the collector: per CUDA device the
    caching allocator's in_use / peak bytes (``torch.cuda.memory_stats``)
    and the card's total (``mem_get_info``) as the limit — only once the
    process has initialised CUDA, so a scrape never creates a context —
    and the host RSS. On the CPU only the host RSS."""
    out: dict = {"devices": {}}
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for index in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(index)
                _, total = torch.cuda.mem_get_info(index)
                out["devices"][f"cuda:{index}"] = {
                    "in_use": stats.get("allocated_bytes.all.current"),
                    "peak": stats.get("allocated_bytes.all.peak"),
                    "limit": total,
                }
    except Exception:  # noqa: BLE001 - a scrape must not fail on a device
        pass
    try:
        with open("/proc/self/status") as fp:
            for line in fp:
                if line.startswith("VmRSS"):
                    out["host_rss_bytes"] = int(line.split()[1]) * 1024
                    break
    except (OSError, ValueError, IndexError):
        pass
    return out


# owners (engines) that asked for memory exposition; ONE shared
# scrape-time collector serves them all — the sample is process-wide
_memory_lock = _threading.Lock()
_memory_refs: set = set()
_memory_active = [False]


def register_memory_collector(owner) -> None:
    """Publish ``mlt_device_mem_bytes{device,kind}`` + host RSS while
    ``owner`` is alive (weakref; the collector retires itself, and its
    series, when every registered owner is gone)."""
    import weakref

    with _memory_lock:
        try:
            _memory_refs.add(weakref.ref(owner))
        except TypeError:  # a non-weakrefable owner: nothing to key on
            return
        if _memory_active[0]:
            return
        _memory_active[0] = True

    def _collect():
        with _memory_lock:
            for ref in list(_memory_refs):
                if ref() is None:
                    _memory_refs.discard(ref)
            if not _memory_refs:
                _memory_active[0] = False
                DEVICE_MEM.clear()
                HOST_RSS.clear()
                return False
        sample = memory_sample()
        for device, kinds in sample.get("devices", {}).items():
            for kind, value in kinds.items():
                if value is not None:
                    DEVICE_MEM.set(value, device=device, kind=kind)
        rss = sample.get("host_rss_bytes")
        if rss is not None:
            HOST_RSS.set(rss)
        return True

    REGISTRY.add_collector(_collect)


def _install_chaos_observer():
    """Count fired injections and land them on the flight recorder; the
    hook is pushed into the chaos registry from here, so that bottom
    layer imports nothing."""
    from ..chaos.registry import set_fire_observer

    def _observe(point):
        CHAOS_FIRED.inc(point=point)
        flight_record("chaos.fire", point=point)

    set_fire_observer(_observe)


_install_chaos_observer()
