"""Handler cores of the gateway's ``/debug`` routes — the port's copy of
``mlrun_tpu/obs/debug.py``: ``/debug/flight``, ``/debug/trace/<trace_id>``
and ``/debug/profile``. The parsing, validation and response shapes live
here; each core raises ``ValueError`` on a bad request, which the route
layer (``serving/asgi.py``) maps to its 400 envelope.

Safety: the profile endpoint is reachable over HTTP (without auth, like
``/__drain__``), so a client-supplied ``output_dir`` is REJECTED — traces
always land under the process's default trace dir — and ``key`` is
restricted to a path-segment-safe charset so it cannot traverse out of
it. ``/debug/trace`` validates the trace id against the header contract's
hex charset before it goes anywhere near a peer URL. The peer fan-out is
the standard library's HTTP client (``urllib.request``).
"""

from __future__ import annotations

import json
import re
import urllib.request

from ..config import OBSERVABILITY_DEFAULTS
from .flight import get_flight_recorder

_SAFE_KEY_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")
_TRACE_ID_RE = re.compile(r"^[0-9a-f]{1,64}$")


def flight_snapshot(kind: str = "", limit=0) -> dict:
    """The GET /debug/flight payload: ring snapshot (oldest first,
    optional exact/``prefix.*`` kind filter, newest-N ``limit``), dump
    count, and the last post-mortem artifact path."""
    try:
        limit = int(limit or 0)
    except (TypeError, ValueError):
        raise ValueError("limit must be an int")
    recorder = get_flight_recorder()
    return {
        "events": recorder.events(kind=(kind or None), limit=limit),
        "ring": len(recorder),
        "dumps": recorder.dumps,
        "last_dump": recorder.last_dump_path,
    }


def trace_peers() -> list[str]:
    """Peer base URLs whose span rings join the waterfall
    (``OBSERVABILITY_DEFAULTS["trace_peers"]`` — process replicas behind
    ``RemoteStep``; in-process replicas already share the process
    tracer's ring)."""
    return [str(p) for p in OBSERVABILITY_DEFAULTS["trace_peers"] or []]


def trace_peer_timeout() -> float:
    """Per-peer fan-out timeout
    (``OBSERVABILITY_DEFAULTS["trace_peer_timeout_s"]``)."""
    return float(OBSERVABILITY_DEFAULTS["trace_peer_timeout_s"])


def trace_snapshot(trace_id: str, peers=None, timeout: float | None = None,
                   local_only: bool = False) -> dict:
    """The GET /debug/trace/<trace_id> payload: one assembled waterfall.

    Reads the local span ring, then fans out to each peer replica's
    ``/debug/trace`` (``local=1`` so peers never re-fan) with a
    PER-REPLICA timeout — a dead replica degrades the waterfall (its
    entry lands in ``sources`` with the error and ``partial`` flips
    true), it never 504s the assembly. On the merged spans the blocking
    critical path and per-phase totals are computed
    (``obs/traceview.py``)."""
    trace_id = str(trace_id or "").strip().lower()
    if not _TRACE_ID_RE.match(trace_id):
        raise ValueError("trace id must be 1-64 hex chars (the "
                         "X-MLT-Trace contract)")
    if timeout is None:
        timeout = trace_peer_timeout()
    from .tracing import get_tracer
    from .traceview import assemble, merge_spans

    local = [span.to_dict()
             for span in get_tracer().spans(trace_id=trace_id)]
    sources: dict = {"local": {"spans": len(local), "ok": True}}
    span_sets = [local]
    partial = False
    if not local_only:
        peer_list = trace_peers() if peers is None else list(peers)
        if peer_list:
            import concurrent.futures
            import time

            def fetch(peer):
                # an error status raises urllib's HTTPError
                url = (f"{str(peer).rstrip('/')}/debug/trace/"
                       f"{trace_id}?local=1")
                with urllib.request.urlopen(url, timeout=timeout) as resp:
                    return json.loads(resp.read()).get("spans") or []

            # concurrent fan-out under a WALL deadline: every peer gets
            # one thread (bounded) and the whole assembly waits at most
            # ~2x the per-peer timeout — a dead or byte-dribbling
            # replica (urlopen's timeout= is per-read, not wall) lands
            # in `sources` as failed instead of stalling the forensics
            # read; its straggler thread is abandoned, never joined
            pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(32, len(peer_list)))
            try:
                futures = {str(peer): pool.submit(fetch, peer)
                           for peer in peer_list}
                deadline = time.monotonic() + 2.0 * timeout
                for peer, future in futures.items():
                    try:
                        peer_spans = future.result(timeout=max(
                            0.0, deadline - time.monotonic()))
                        span_sets.append(peer_spans)
                        sources[peer] = {"spans": len(peer_spans),
                                         "ok": True}
                    except Exception as exc:  # noqa: BLE001 - a dead
                        # replica degrades the waterfall, never 504s it
                        sources[peer] = {"ok": False,
                                         "error": str(exc) or
                                         type(exc).__name__}
                        partial = True
            finally:
                pool.shutdown(wait=False, cancel_futures=True)
    out = assemble(trace_id, merge_spans(*span_sets))
    out["sources"] = sources
    out["partial"] = partial
    return out


def profile_request(body: dict) -> dict:
    """The POST /debug/profile core: disarm, or arm an on-demand
    ``torch.profiler`` capture for the next N steps/seconds
    (``utils/profiler``)."""
    from ..utils.profiler import arm_profile, disarm_profile

    body = body or {}
    if body.get("disarm"):
        # stop_active: the HTTP disarm is the operator remedy for a
        # capture whose claiming loop went away
        return {"disarmed": disarm_profile(stop_active=True)}
    if body.get("output_dir"):
        # the arm request crosses an HTTP boundary: a client-chosen
        # directory would be an arbitrary-path write primitive
        raise ValueError("output_dir is not accepted over HTTP — traces "
                         "land under the process's default trace dir")
    key = str(body.get("key", "") or "xla-trace")
    if not _SAFE_KEY_RE.match(key) or not key.strip("."):
        # a pure-dot key ("." / "..") would resolve OUT of the traces
        # dir despite matching the charset
        raise ValueError("key must match [A-Za-z0-9._-]{1,64} and "
                         "contain a non-dot character")
    try:
        steps = int(body.get("steps", 0) or 0)
        seconds = float(body.get("seconds", 0) or 0)
    except (TypeError, ValueError):
        raise ValueError("steps must be an int and seconds a number")
    return arm_profile(steps=steps, seconds=seconds, key=key)
