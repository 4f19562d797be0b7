"""Routers and ensembles — the port's copy of
``mlrun_tpu/serving/routers.py``: ``ModelRouter`` (by url path or body
field), ``ParallelRun`` (fan out and merge), ``VotingEnsemble``,
``PrefixAffinityRouter`` (consistent-hash prefix affinity over replica
routes, with 503-class re-dispatch) and the two enrichment routers, which
need the feature store once ``feature_vector_uri`` is set."""

from __future__ import annotations

import concurrent.futures
import copy
import time

import numpy as np

from ..common.retry import RetryPolicy, compute_backoff
from ..utils import logger
from .resilience import check_deadline, deadline_remaining


class BaseModelRouter:
    """Route events to child model steps by url path or body field."""

    def __init__(self, context=None, name: str | None = None,
                 routes: dict | None = None, protocol: str = "v2",
                 url_prefix: str | None = None, health_prefix: str | None = None,
                 **kwargs):
        self.context = context
        self.name = name or "router"
        self.routes = routes or {}
        self.protocol = protocol
        self.url_prefix = url_prefix or f"/{self.protocol}/models"
        self.health_prefix = health_prefix or f"/{self.protocol}/health"
        self.inputs_key = "inputs"
        self._kwargs = kwargs

    def post_init(self, mode: str = "sync"):
        pass

    def parse_event(self, event):
        """Normalize body: allow raw lists as {'inputs': [...]}."""
        body = event.body
        if isinstance(body, (list, np.ndarray)):
            event.body = {self.inputs_key: body}
        return event

    def _resolve_route(self, event) -> tuple[str, str]:
        """Return (model_name, op) parsed from the path or body."""
        path = getattr(event, "path", "/") or "/"
        if path.startswith(self.url_prefix):
            rest = path[len(self.url_prefix):].strip("/")
            parts = rest.split("/") if rest else []
            model = parts[0] if parts else ""
            op = parts[1] if len(parts) > 1 else "infer"
            return model, op
        body = event.body
        if isinstance(body, dict):
            return body.get("model", ""), body.get("operation", "infer")
        return "", "infer"

    def do_event(self, event, *args, **kwargs):
        event = self.parse_event(event)
        path = getattr(event, "path", "/") or "/"
        if path.startswith(self.health_prefix) or path in ("/", ""):
            if getattr(event, "method", "GET") == "GET" and not isinstance(
                    event.body, dict):
                event.body = {
                    "models": list(self.routes.keys()),
                    "router": self.name,
                }
                return event
        model, op = self._resolve_route(event)
        if event.body is None and getattr(event, "method", "POST") == "GET" \
                and (not model or model not in self.routes):
            event.body = {"models": list(self.routes.keys()),
                          "router": self.name}
            return event
        if not model:
            if len(self.routes) == 1:
                model = next(iter(self.routes))
            else:
                event.body = {"models": list(self.routes.keys())}
                return event
        if model not in self.routes:
            raise ValueError(
                f"model '{model}' not found in routes {list(self.routes)}")
        # an expired request must not reach the model at all
        check_deadline(event, f"{self.name}/{model}")
        return self.routes[model].run(event)


class ModelRouter(BaseModelRouter):
    """Default router."""


class ParallelRun(BaseModelRouter):
    """Fan an event to all routes in parallel (a thread pool) and merge
    the results."""

    def __init__(self, *args, extend_event=None, executor_type: str = "thread",
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.executor_type = executor_type
        self.extend_event = extend_event

    def merger(self, body: dict, results: dict) -> dict:
        for result in results.values():
            if isinstance(result, dict):
                body.update(result)
        return body

    def do_event(self, event, *args, **kwargs):
        event = self.parse_event(event)
        # fan-out multiplies the cost of serving an expired request by
        # len(routes) — check the budget once before dispatching anywhere
        check_deadline(event, self.name)
        results = {}
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, len(self.routes))) as pool:
            futures = {
                name: pool.submit(step.run, copy.copy(event))
                for name, step in self.routes.items()
            }
            for name, future in futures.items():
                out = future.result()
                results[name] = out.body if hasattr(out, "body") else out
        body = event.body if isinstance(event.body, dict) else {}
        event.body = self.merger(body, results)
        return event


class PrefixAffinityRouter(BaseModelRouter):
    """Consistent-hash prefix-affinity routing over LLM replica routes.

    Routes are interchangeable model replicas (each typically an
    ``LLMModelServer`` — in-process engine or a ``RemoteStep``-backed
    process); the router keys each request on the prompt's leading
    prefix blocks (``prefix.block_chain_key``) so requests sharing a hot
    prefix hit the replica whose KV cache already holds it. A 503-class
    failure (draining or stopped replica, open breaker, shed) re-routes
    to the next ring node with bounded deterministic backoff instead of
    surfacing the failure to the client; an explicit
    ``/v2/models/<name>`` path still addresses one replica directly.
    """

    def __init__(self, *args, route_block_tokens: int = 64,
                 route_blocks: int = 4, vnodes: int = 64,
                 max_dispatch_attempts: int = 3, backoff: float = 0.05,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.route_block_tokens = int(route_block_tokens)
        self.route_blocks = int(route_blocks)
        self.max_dispatch_attempts = int(max_dispatch_attempts)
        self._retry_policy = RetryPolicy(
            max_retries=self.max_dispatch_attempts, backoff=float(backoff),
            backoff_factor=2.0, backoff_max=1.0, jitter=0.1)
        from .fleet import ConsistentHashRing

        self._ring = ConsistentHashRing(vnodes=int(vnodes))
        self.redispatches = 0

    def post_init(self, mode: str = "sync"):
        for name in self.routes:
            self._ring.add(name)

    def _routing_key(self, event) -> int:
        """Key on the first input's leading blocks: token lists hash
        token blocks (the radix-index identity); strings hash byte
        blocks, which is the same shared-prefix grouping one tokenizer
        hop earlier. The v2 body's ``adapter`` id namespaces the key —
        the same prompt under two tenants is two routing identities. A
        tenant with canary-loop
        state resolves to its effective versioned id first
        (serving/canary.py, key computation only — the downstream server
        meters and applies the split), so canary traffic routes as its
        own identity. NOTE: with string inputs and no explicit
        ``request_key`` the router's side guess keys on prompt BYTES
        while the engine keys on tokens — pass ``request_key`` when
        exact router/engine side agreement matters (locality-only skew
        otherwise)."""
        from .canary import resolve_adapter
        from .prefix import block_chain_key

        body = event.body if isinstance(event.body, dict) else {}
        inputs = body.get(self.inputs_key) or []
        first = inputs[0] if inputs else ""
        if isinstance(first, str):
            first = list(first.encode())
        adapter = str(body.get("adapter", "") or "")
        if adapter:
            adapter = resolve_adapter(
                adapter, list(first),
                body.get("request_key") or None, count=False)
        return block_chain_key(list(first), self.route_block_tokens,
                               max_blocks=self.route_blocks,
                               adapter=adapter)

    def do_event(self, event, *args, **kwargs):
        from .fleet import redispatchable

        event = self.parse_event(event)
        path = getattr(event, "path", "/") or "/"
        if path.startswith(self.health_prefix):
            event.body = {"models": list(self.routes.keys()),
                          "router": self.name}
            return event
        model, _ = self._resolve_route(event)
        if model:
            # an explicit replica address bypasses affinity
            # (ops/debugging); an UNKNOWN one is an addressing error the
            # caller must see (base-router contract), not traffic to
            # silently affinity-route — a stale address after scale-down
            # would otherwise look like a healthy replica
            if model not in self.routes:
                raise ValueError(
                    f"model '{model}' not found in routes "
                    f"{list(self.routes)}")
            check_deadline(event, f"{self.name}/{model}")
            return self.routes[model].run(event)
        if getattr(event, "method", "POST") == "GET" or not isinstance(
                event.body, dict):
            event.body = {"models": list(self.routes.keys()),
                          "router": self.name}
            return event
        key = self._routing_key(event)
        order = self._ring.preference(key)
        last_exc = None
        for attempt, name in enumerate(order[:self.max_dispatch_attempts]):
            check_deadline(event, f"{self.name}/{name}")
            if attempt:
                delay = compute_backoff(
                    attempt - 1, self._retry_policy,
                    seed=f"{self.name}:{key}")
                remaining = deadline_remaining(event)
                if remaining is not None and delay >= remaining:
                    break  # no budget for another replica
                if delay > 0:
                    time.sleep(delay)
            try:
                return self.routes[name].run(copy.copy(event))
            except Exception as exc:  # noqa: BLE001 - classified below
                if not redispatchable(exc):
                    raise
                last_exc = exc
                self.redispatches += 1
                incr = getattr(self.context, "incr", None)
                if callable(incr):
                    incr(f"router.{self.name}.redispatched")
                logger.warning("affinity router re-dispatching",
                               router=self.name, replica=name,
                               attempt=attempt + 1, error=str(exc))
        from .resilience import ReplicaUnavailableError

        raise ReplicaUnavailableError(
            f"router '{self.name}' exhausted its replicas "
            f"({min(len(order), self.max_dispatch_attempts)} tried)"
        ) from last_exc


class VotingTypes:
    classification = "classification"
    regression = "regression"


class VotingEnsemble(BaseModelRouter):
    """Send the event to all models and vote/average."""

    def __init__(self, *args, vote_type: str | None = None,
                 weights: dict | None = None, prediction_col_name: str = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.vote_type = vote_type
        self.weights = weights or {}
        self.prediction_col_name = prediction_col_name or "prediction"

    def _vote(self, predictions: dict[str, list]) -> list:
        names = list(predictions.keys())
        arrays = [np.asarray(predictions[n], dtype=float) for n in names]
        stacked = np.stack(arrays)  # [models, batch, ...]
        weights = np.asarray(
            [self.weights.get(n, 1.0) for n in names], dtype=float)
        weights = weights / weights.sum()
        vote_type = self.vote_type or (
            VotingTypes.classification
            if np.allclose(stacked, np.round(stacked))
            else VotingTypes.regression)
        if vote_type == VotingTypes.regression:
            return np.tensordot(weights, stacked, axes=1).tolist()
        # weighted majority per sample
        out = []
        flat = stacked.reshape(stacked.shape[0], -1)
        for col in range(flat.shape[1]):
            votes: dict = {}
            for m, w in enumerate(weights):
                votes[flat[m, col]] = votes.get(flat[m, col], 0.0) + w
            out.append(max(votes.items(), key=lambda kv: kv[1])[0])
        return np.asarray(out).reshape(stacked.shape[1:]).tolist()

    def do_event(self, event, *args, **kwargs):
        event = self.parse_event(event)
        path = getattr(event, "path", "/") or "/"
        model, op = self._resolve_route(event)
        if model and model in self.routes:
            # direct route to a specific member model
            return self.routes[model].run(event)
        if op in ("metrics", "ready") or (
                getattr(event, "method", "POST") == "GET"):
            event.body = {"models": list(self.routes.keys()),
                          "router": self.name}
            return event
        check_deadline(event, self.name)
        predictions = {}
        for name, step in self.routes.items():
            sub = copy.copy(event)
            sub.body = copy.deepcopy(event.body)
            out = step.run(sub)
            body = out.body if hasattr(out, "body") else out
            predictions[name] = body.get("outputs") if isinstance(body, dict) \
                else body
        voted = self._vote(predictions)
        event.body = {
            "id": getattr(event, "id", None),
            "model_name": self.name,
            "outputs": voted,
            "model_version": "v1",
        }
        return event


class EnrichmentModelRouter(ModelRouter):
    """Router that enriches the event with feature-store features before
    routing. Without ``feature_vector_uri`` it routes as ``ModelRouter``;
    with one it needs the feature store, which the port does not have yet
    (ROADMAP.md item 11)."""

    def __init__(self, *args, feature_vector_uri: str = "",
                 impute_policy: dict | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.feature_vector_uri = feature_vector_uri
        self.impute_policy = impute_policy or {}
        self._service = None

    def post_init(self, mode: str = "sync"):
        if self.feature_vector_uri:
            from .resilience import not_ported

            raise not_ported("feature-vector enrichment "
                             f"({self.feature_vector_uri!r})", 11)

    def parse_event(self, event):
        event = super().parse_event(event)
        if self._service is not None and isinstance(event.body, dict):
            entities = event.body.get(self.inputs_key, [])
            enriched = self._service.get(
                [e if isinstance(e, dict) else {"id": e} for e in entities],
                as_list=True)
            event.body[self.inputs_key] = enriched
        return event


class EnrichmentVotingEnsemble(VotingEnsemble, EnrichmentModelRouter):
    """Voting ensemble with feature enrichment (as ``VotingEnsemble``
    without ``feature_vector_uri``)."""
