"""Canary traffic splitting and adapter version aliasing — the port's copy
of ``mlrun_tpu/serving/canary.py`` (same names, same sha256 buckets, so a
(tenant, request key) pair lands on the same side in both packages).

Adapter names are immutable versions: re-publishing different weights
under one name would serve stale prefix KV. A continuous-tuning loop
publishes each retrain under a fresh VERSIONED id (``<tenant>@v<n>``) and
this router maps client-facing tenant ids onto effective adapter ids at
the submit boundary:

- **alias**: ``tenant -> versioned id``, what "stable" currently means for
  the tenant; promotion re-points it.
- **split**: while a canary is under evaluation, a deterministic hash of
  ``(tenant, request key)`` sends ``fraction`` of the tenant's traffic to
  the canary id. The same request key always lands on the same side,
  across processes, restarts and replicas (sha256, never ``hash()``).

The effective id is resolved BEFORE the prefix cache, the fleet routing
key and the engine's adapter bank see the request, so canary traffic is a
distinct identity end to end. Resolution is idempotent: a versioned id
(anything containing ``@``) carries no router state. ``@`` is reserved:
client tenant ids must not contain it.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional

from ..obs import CANARY_REQUESTS

VERSION_SEP = "@"


def split_key_for(prompt_tokens, explicit=None) -> str:
    """The request key the hash split buckets on: an explicit client key
    (session/user id — keeps one conversation on one side) or, absent
    that, a stable digest of the prompt tokens (same prompt, same
    side)."""
    if explicit:
        return str(explicit)
    return hashlib.sha256(
        ",".join(str(int(t)) for t in prompt_tokens).encode()
    ).hexdigest()[:16]


class CanarySplit:
    """One tenant's active canary: the versioned canary id and the
    traffic fraction it receives."""

    __slots__ = ("tenant", "canary", "fraction")

    def __init__(self, tenant: str, canary: str, fraction: float):
        self.tenant = tenant
        self.canary = canary
        self.fraction = float(fraction)


class CanaryRouter:
    """Thread-safe alias + split table consulted by every submit path
    (the fleet and the engines). Dark cost is one dict lookup per
    request with an adapter; requests without router state pass through
    untouched and unmetered."""

    def __init__(self):
        self._lock = threading.Lock()
        self._aliases: dict[str, str] = {}
        self._splits: dict[str, CanarySplit] = {}

    # -- state ---------------------------------------------------------------
    @staticmethod
    def _check_tenant(tenant: str):
        if not tenant or VERSION_SEP in tenant:
            raise ValueError(
                f"'{tenant}' is not a client tenant id ('{VERSION_SEP}' "
                f"is reserved for loop-managed versioned adapters)")

    def stable_id(self, tenant: str) -> str:
        """The versioned id the tenant's stable traffic currently
        resolves to (the tenant id itself before any promotion)."""
        with self._lock:
            return self._aliases.get(tenant, tenant)

    def set_alias(self, tenant: str, versioned: str):
        self._check_tenant(tenant)
        with self._lock:
            self._aliases[tenant] = versioned

    def split(self, tenant: str) -> Optional[CanarySplit]:
        with self._lock:
            return self._splits.get(tenant)

    def active_splits(self) -> dict:
        with self._lock:
            return dict(self._splits)

    def set_split(self, tenant: str, canary: str, fraction: float):
        self._check_tenant(tenant)
        if canary == tenant:
            raise ValueError("canary id must differ from the tenant id")
        if not 0.0 < float(fraction) < 1.0:
            raise ValueError(
                f"canary fraction must be in (0, 1), got {fraction}")
        with self._lock:
            self._splits[tenant] = CanarySplit(tenant, canary, fraction)

    def clear_split(self, tenant: str):
        with self._lock:
            self._splits.pop(tenant, None)

    def promote(self, tenant: str) -> str:
        """Re-point the tenant's stable id at the active canary and end
        the split; returns the promoted versioned id."""
        with self._lock:
            split = self._splits.pop(tenant, None)
            if split is None:
                raise ValueError(f"tenant '{tenant}' has no active canary")
            self._aliases[tenant] = split.canary
            return split.canary

    def export_state(self) -> dict:
        """Serializable view of the whole routing table (aliases +
        splits) — what a restarted continuous-tuning controller rebuilds
        from its intent journal. ``bucket()`` is a pure sha256 of
        ``(tenant, request key)``, so once the canary id and fraction
        are restored the split is hash-identical by construction: every
        request key resolves to the same side it did before the crash."""
        with self._lock:
            return {
                "aliases": dict(self._aliases),
                "splits": {t: {"canary": s.canary, "fraction": s.fraction}
                           for t, s in self._splits.items()},
            }

    def restore_state(self, state: dict):
        """Install an :meth:`export_state` view, validating every entry
        through the normal setters."""
        for tenant, versioned in (state.get("aliases") or {}).items():
            self.set_alias(tenant, versioned)
        for tenant, split in (state.get("splits") or {}).items():
            self.set_split(tenant, split["canary"], split["fraction"])

    # -- resolution ----------------------------------------------------------
    @staticmethod
    def bucket(tenant: str, split_key: str) -> float:
        """Deterministic [0, 1) bucket for (tenant, request key); a key's
        bucket is fixed, so raising the fraction only ADDS keys to the
        canary side, never reshuffles existing assignments."""
        digest = hashlib.sha256(
            f"{tenant}|{split_key}".encode()).digest()
        return int.from_bytes(digest[:8], "big") / float(1 << 64)

    def resolve(self, adapter: str, split_key: str,
                count: bool = False) -> tuple[str, str]:
        """Map a client adapter id to its effective versioned id:
        ``(effective, side)`` with side ``"canary"``/``"stable"`` when
        router state applied, ``""`` when the name passed through
        untouched. ``count=True`` meters the decision on
        ``mlt_canary_requests_total`` — submit boundaries pass it,
        routing-key computations don't."""
        if not adapter:
            return adapter, ""
        with self._lock:
            split = self._splits.get(adapter)
            stable = self._aliases.get(adapter, adapter)
        if split is None and stable == adapter:
            return adapter, ""
        side, effective = "stable", stable
        if split is not None and \
                self.bucket(adapter, split_key) < split.fraction:
            side, effective = "canary", split.canary
        if count and split is not None:
            # metered only while a split is LIVE — post-promotion alias
            # resolution is plain steady-state traffic, and counting it
            # "stable" forever would dilute every later experiment's
            # canary/(canary+stable) fraction
            CANARY_REQUESTS.inc(adapter=adapter, side=side)
        return effective, side

    @staticmethod
    def is_managed(name: str) -> bool:
        """True for loop-managed versioned/canary ids (never client
        tenant ids) — e.g. the monitor's drift state machine skips
        them."""
        return VERSION_SEP in (name or "")


# process-wide router consulted by the submit paths; None = the loop is
# not running and every request passes through at one attribute read
_router: Optional[CanaryRouter] = None


def get_canary_router() -> Optional[CanaryRouter]:
    return _router


def set_canary_router(router: Optional[CanaryRouter]):
    global _router
    _router = router


def resolve_adapter(adapter: str, prompt_tokens, request_key=None,
                    count: bool = False) -> str:
    """One-stop resolution for submit paths: consult the process router
    (if any) with the request's split key. Returns the effective adapter
    id — identical to the input when the loop is dark."""
    if not adapter:
        return adapter
    router = _router
    if router is None:
        return adapter
    effective, _ = router.resolve(
        adapter, split_key_for(prompt_tokens, request_key), count=count)
    return effective
