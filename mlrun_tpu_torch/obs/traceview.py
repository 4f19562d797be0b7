"""Cross-replica trace assembly and the blocking critical path — the
port's copy of ``mlrun_tpu/obs/traceview.py``.

``GET /debug/trace/<trace_id>`` turns one trace id — typically lifted off a
histogram exemplar — into a single waterfall: the local span ring's spans
for that trace, merged with spans fanned in from peer replicas' rings
(``obs/debug.py``). On the assembled tree this module computes the
**blocking critical path** — the longest chain of non-overlapping child
spans under the root, with gap time attributed to the parent span's phase
— and per-phase totals that reconcile against the request's phase ledger
(``obs/reqledger.py``).

Stdlib only; spans are the plain dicts ``Span.to_dict`` produces, so
HTTP-fetched and local spans merge uniformly.
"""

from __future__ import annotations

# span-name → ledger phase for critical-path segments; a parent's gap
# time lands on the PARENT's phase (a gap under server.run is time the
# request was in the server but in no child span — queue/dispatch wait)
_SPAN_PHASE = {
    "llm.prefill": "prefill",
    "llm.decode": "decode_active",
    "server.run": "queue_wait",
}


def span_phase(name: str) -> str:
    if name in _SPAN_PHASE:
        return _SPAN_PHASE[name]
    if name.startswith("remote."):
        return "network"
    if name.startswith(("step.", "server.")):
        return "queue_wait"
    return "other"


def merge_spans(*span_lists) -> list[dict]:
    """Merge span dicts from several rings, deduplicating by span_id
    (the local ring and an in-process replica's ring are the same ring;
    a re-fetched remote span must not double its duration)."""
    seen: set = set()
    merged: list[dict] = []
    for spans in span_lists:
        for span in spans or ():
            span_id = span.get("span_id")
            if span_id in seen:
                continue
            seen.add(span_id)
            merged.append(span)
    merged.sort(key=lambda s: (s.get("start") or 0.0, s.get("span_id")))
    return merged


def _finished(spans: list[dict]) -> list[dict]:
    return [s for s in spans if s.get("end") is not None]


def find_root(spans: list[dict]):
    """The waterfall root: the longest finished span whose parent is not
    in the assembled set (a header-joined trace may reference a parent
    span id that lives in an unreachable caller's ring)."""
    finished = _finished(spans)
    if not finished:
        return None
    ids = {s["span_id"] for s in finished}
    orphans = [s for s in finished
               if not s.get("parent_id") or s["parent_id"] not in ids]
    pool = orphans or finished
    return max(pool, key=lambda s: s["end"] - s["start"])


def critical_path(spans: list[dict]) -> list[dict]:
    """Blocking critical path through the span tree, as a flat list of
    segments ordered by start time.

    For each span on the path, the chain of its non-overlapping children
    that reaches furthest back from the span's end is followed
    recursively; the intervals no chosen child covers are the span's own
    blocking time (``kind="self"`` segments — for a parent that is a
    scheduler/server span this is the queue/dispatch gap the ledger
    calls ``queue_wait``). Segment durations partition the root span's
    duration exactly, so ``sum(self_s) == root wall`` by construction.
    """
    finished = _finished(spans)
    root = find_root(finished)
    if root is None:
        return []
    children: dict[str, list[dict]] = {}
    for span in finished:
        parent = span.get("parent_id")
        if parent:
            children.setdefault(parent, []).append(span)

    segments: list[dict] = []

    def seg(span: dict, start: float, end: float, kind: str):
        if end - start <= 0:
            return
        segments.append({
            "name": span["name"], "span_id": span["span_id"],
            "start": start, "end": end,
            "self_s": end - start, "kind": kind,
            "phase": span_phase(span["name"]),
            "replica": (span.get("attrs") or {}).get("replica", ""),
        })

    def walk(span: dict):
        start = max(span["start"], root["start"])
        end = min(span["end"], root["end"])
        # pick the blocking chain: from the span's end walk backwards,
        # each step taking the child with the latest end that finishes
        # before the current cursor (ties/overlaps skipped — they are
        # concurrent, not blocking)
        kids = sorted(
            (c for c in children.get(span["span_id"], ())
             if c["end"] > start and c["start"] < end),
            key=lambda c: c["end"], reverse=True)
        chain: list[dict] = []
        cursor = end
        for child in kids:
            if child["end"] <= cursor:
                chain.append(child)
                cursor = max(child["start"], start)
        chain.reverse()
        # emit: alternating parent-gap and child segments, left to right
        pos = start
        for child in chain:
            child_start = max(child["start"], start)
            child_end = min(child["end"], end)
            seg(span, pos, child_start, "self")
            walk(child)
            pos = child_end
        seg(span, pos, end, "self")

    walk(root)
    segments.sort(key=lambda s: s["start"])
    return segments


def phase_totals(segments: list[dict]) -> dict[str, float]:
    """Per-phase wall totals over the critical path. For an
    ``llm.decode`` segment whose span carried the request's ledger
    breakdown this is refined by the ledger's decode split in
    :func:`assemble`; here it is the raw segment mapping."""
    totals: dict[str, float] = {}
    for segment in segments:
        phase = segment["phase"]
        totals[phase] = totals.get(phase, 0.0) + segment["self_s"]
    return {k: v for k, v in sorted(totals.items()) if v > 0}


def assemble(trace_id: str, spans: list[dict]) -> dict:
    """One waterfall payload for ``trace_id``: the merged spans (start
    order), the blocking critical path, per-phase totals, and — when an
    engine span carried the request's phase ledger (``attrs.timing``) —
    the ledger view plus a reconciliation block comparing the two
    attributions (they must agree on the wall; tests assert it)."""
    spans = [s for s in spans if s.get("trace_id") == trace_id]
    segments = critical_path(spans)
    totals = phase_totals(segments)
    root = find_root(spans)
    out = {
        "trace_id": trace_id,
        "spans": spans,
        "span_count": len(spans),
        "replicas": sorted({(s.get("attrs") or {}).get("replica")
                            for s in spans
                            if (s.get("attrs") or {}).get("replica")}),
        "root": root["name"] if root else None,
        "critical_path": segments,
        "phase_totals": totals,
        "critical_path_s": sum(s["self_s"] for s in segments),
    }
    # the request ledger rides the llm.decode span (engine _finish); a
    # disaggregated request has one per hop — merge them
    ledgers = [s["attrs"]["timing"] for s in spans
               if isinstance((s.get("attrs") or {}).get("timing"), dict)]
    if ledgers:
        phases: dict[str, float] = {}
        wall = 0.0
        for timing in ledgers:
            for phase, seconds in (timing.get("phases") or {}).items():
                phases[phase] = phases.get(phase, 0.0) + seconds
            wall += timing.get("wall_s", 0.0)
        out["ledger"] = {"phases": phases, "wall_s": wall}
        out["reconciliation"] = {
            "critical_path_s": out["critical_path_s"],
            "ledger_wall_s": wall,
            "delta_s": out["critical_path_s"] - wall,
        }
    return out
