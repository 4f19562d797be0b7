"""Run-level retry policy engine and failure classifier — the port's copy
of ``mlrun_tpu/common/retry.py``: for every failed resource the service
asks whether the user or the infrastructure was at fault
(:func:`classify_failure`), whether to try again
(:func:`resolve_retry_policy`, ``RetryPolicy.retries_left``) and how long
to wait (:func:`compute_backoff`, whose jitter draw is keyed on (seed,
attempt), so a given seed yields the reference's sequence exactly). The
resubmission itself lives in ``service/runtime_handlers.py``; the engine
fleet and the run objects use ``FailureClass`` and the backoff."""

from __future__ import annotations

import dataclasses
import random
import re

from ..config import service_config


class FailureClass:
    """Coarse failure taxonomy recorded on ``status.failure_class``."""

    # retryable infra faults
    preemption = "preemption"                  # spot/preemptible eviction
    # ONE pod-slice of a multi-slice job evicted while the job itself is
    # alive — the elastic case: survivors reshard and keep training, the
    # monitor submits only a replacement slice (not a full resubmit).
    # Distinguished from ``preemption`` (whole job dead) by the provider's
    # slice_status probe / slice-scoped failure text.
    slice_preempted = "slice_preempted"
    image_pull_backoff = "image_pull_backoff"  # registry flake
    node_drain = "node_drain"                  # node shutdown / drain
    http_5xx = "http_5xx"                      # control-plane 5xx
    resource_vanished = "resource_vanished"    # GC'd / deleted out-of-band
    infra = "infra"                            # generic infra failure
    stalled = "stalled"                        # heartbeat-silent run
    # permanent
    user_code = "user_code"                    # handler raised / exit != 0

    @staticmethod
    def retryable() -> list[str]:
        return [
            FailureClass.preemption, FailureClass.slice_preempted,
            FailureClass.image_pull_backoff,
            FailureClass.node_drain, FailureClass.http_5xx,
            FailureClass.resource_vanished, FailureClass.infra,
            FailureClass.stalled,
        ]


# keyword → class, checked in order (first hit wins). Sources: GKE pod
# reasons (Evicted/Preempted/NodeShutdown), kubelet waiting reasons
# (ImagePullBackOff/ErrImagePull), and control-plane error text.
_PATTERNS: list[tuple[str, str]] = [
    # slice-scoped text must outrank the generic preemption pattern
    # ("slice 1 preempted" contains "preempt") — first hit wins
    (r"slice[\s_-]*\d*[\s_-]*(preempt|fail|evict)|slicefailed|failedslice",
     FailureClass.slice_preempted),
    (r"preempt|evict|spot|gke-spot", FailureClass.preemption),
    (r"imagepullbackoff|errimagepull|image\s*pull", FailureClass.image_pull_backoff),
    (r"node\s*drain|nodeshutdown|node\s*shutdown|unschedulable|"
     r"deletiontimestamp", FailureClass.node_drain),
    (r"\b50[0-9]\b|http\s*5xx|server\s+error|bad\s+gateway|"
     r"service\s+unavailable", FailureClass.http_5xx),
]


def classify_failure(probe_error: str | None = None,
                     run_error: str | None = None,
                     reason: str | None = None,
                     run_reported_terminal: bool = False) -> str:
    """Classify a failed/vanished resource.

    The load-bearing signal is ``run_reported_terminal``: the in-run
    process writes a terminal error state (with traceback) when *user
    code* raises, so a failed resource whose run doc already reached a
    terminal state is a permanent user-code failure. A resource that died
    while its run doc still says running/pending never got to report —
    that is infrastructure (preemption, OOM-kill of the node, GC), and it
    is retryable. Text patterns then refine the infra class.
    """
    if run_reported_terminal:
        return FailureClass.user_code
    text = " ".join(t for t in (probe_error, reason, run_error) if t).lower()
    for pattern, cls in _PATTERNS:
        if re.search(pattern, text):
            return cls
    if probe_error:
        # state probe itself failed → the resource is gone (404 after GC,
        # dead pid, deleted JobSet)
        return FailureClass.resource_vanished
    return FailureClass.infra


@dataclasses.dataclass
class RetryPolicy:
    """Resolved run-level retry/stall policy (spec overlaid on config
    defaults — see ``resolve_retry_policy``)."""

    max_retries: int = 0
    backoff: float = 5.0          # first-retry delay, seconds
    backoff_factor: float = 2.0   # exponential growth per attempt
    backoff_max: float = 300.0    # delay ceiling
    jitter: float = 0.1           # ± fraction of the delay
    retry_on: tuple = ()          # failure classes worth retrying
    stall_timeout: float = -1.0   # heartbeat-silence threshold; <=0 off
    on_stall: str = "abort"       # "abort" | "resubmit"

    def retries_left(self, retry_count: int) -> bool:
        return int(retry_count) < int(self.max_retries)


def resolve_retry_policy(spec: dict | None = None) -> RetryPolicy:
    """Overlay a run's ``spec.retry_policy`` dict on the service defaults
    (``runs.retries`` + ``runs.heartbeat`` of ``config.SERVICE_DEFAULTS``)."""
    defaults = _config_defaults()
    spec = dict(spec or {})
    fields = {f.name for f in dataclasses.fields(RetryPolicy)}
    merged = {k: v for k, v in {**defaults, **spec}.items()
              if k in fields and v is not None}
    if "retry_on" in merged:
        merged["retry_on"] = tuple(merged["retry_on"])
    policy = RetryPolicy(**merged)
    if not policy.retry_on:
        policy.retry_on = tuple(FailureClass.retryable())
    return policy


def _config_defaults() -> dict:
    out: dict = dict(service_config("runs.retries"))
    heartbeat = service_config("runs.heartbeat")
    out.setdefault("stall_timeout", heartbeat.get("stall_timeout"))
    out.setdefault("on_stall", heartbeat.get("on_stall"))
    return out


def compute_backoff(attempt: int, policy: RetryPolicy, seed: str = "") -> float:
    """Exponential backoff with *deterministic* jitter: the jitter draw is
    keyed on (seed, attempt) so a given run's retry timeline is
    reproducible — chaos tests and postmortems see the same schedule.
    ``attempt`` is 0-based (0 → first retry)."""
    if policy.backoff <= 0:
        return 0.0
    delay = min(policy.backoff * (policy.backoff_factor ** attempt),
                policy.backoff_max)
    if policy.jitter > 0:
        rng = random.Random(f"{seed}:{attempt}")
        delay *= 1.0 + rng.uniform(-policy.jitter, policy.jitter)
    return max(0.0, delay)
