"""Run API schemas (reference analog: mlrun/common/schemas/runs.py)."""

from __future__ import annotations

from typing import Optional

import pydantic


class RunIdentifier(pydantic.BaseModel):
    kind: str = "run"
    uid: Optional[str] = None
    iter: Optional[int] = None


class RetryPolicy(pydantic.BaseModel):
    """Run-level fault-tolerance policy carried on ``spec.retry_policy``.

    The reference has nothing here — an MPIJob worker failure fails the
    run (SURVEY §5.3). On preemptible GPU nodes eviction is the common
    case, so runs declare how the service should respond: how many
    resubmissions, exponential backoff shape, which failure classes are
    worth retrying (see ``common/retry.py FailureClass``), and what to do
    with a heartbeat-silent (stalled) run. Service-side enforcement lives
    in ``service/runtime_handlers.py``.
    """

    max_retries: int = pydantic.Field(0, ge=0)
    backoff: float = pydantic.Field(5.0, ge=0)
    backoff_factor: float = pydantic.Field(2.0, ge=1.0)
    backoff_max: float = pydantic.Field(300.0, ge=0)
    jitter: float = pydantic.Field(0.1, ge=0, le=1.0)
    # failure classes to retry; empty/None = every retryable infra class
    retry_on: Optional[list[str]] = None
    # heartbeat-silence threshold in seconds; <= 0 disables the watchdog
    stall_timeout: float = -1.0
    on_stall: str = "abort"  # "abort" | "resubmit"

    # a typo'd key would otherwise silently disarm the policy (the raw
    # dict reaches resolve_retry_policy, which keeps known keys only)
    model_config = pydantic.ConfigDict(extra="forbid")

    @pydantic.field_validator("on_stall")
    @classmethod
    def _check_on_stall(cls, value: str) -> str:
        if value not in ("abort", "resubmit"):
            raise ValueError("on_stall must be 'abort' or 'resubmit'")
        return value

    @pydantic.field_validator("retry_on")
    @classmethod
    def _check_retry_on(cls, value):
        # a typo'd class name would otherwise silently disable retries —
        # the classifier's output would never match it
        if value is None:
            return value
        from ..retry import FailureClass

        unknown = set(value) - set(FailureClass.retryable())
        if unknown:
            raise ValueError(
                f"unknown retry_on failure classes {sorted(unknown)}; "
                f"valid: {FailureClass.retryable()}")
        return value


class RunRecord(pydantic.BaseModel):
    kind: str = "run"
    metadata: dict = pydantic.Field(default_factory=dict)
    spec: dict = pydantic.Field(default_factory=dict)
    status: dict = pydantic.Field(default_factory=dict)

    model_config = pydantic.ConfigDict(extra="allow")
